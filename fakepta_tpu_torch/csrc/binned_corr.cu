// Fused correlation + angular binning for Hopper (sm_90a).
//
// Replaces the TPU kernel fakepta_tpu/ops/pallas_kernels.py::
// binned_correlation (kernel body _binned_corr_kernel_mxu, pallas_call at
// pallas_kernels.py:205). Per realization r:
//   corr = res_l[r] res_f[r]^T   (PL x PF, never written to device memory)
//   out[r, n] = sum_pq corr[p, q] w[n, p, q]   (n < NB: curve bins, OS slots,
//                                               and the auto trace last)
//
// What bounds it on an H100: on the single-device path res_l is res_f, so
// the block is symmetric and needs only its P(P+1)/2 distinct pairs:
// R P (P+1) T FLOPs (2 R PL PF T for two operand sets) against R P T 4
// bytes of residual read, about (P+1)/4 = 25 FLOP per byte at the flagship
// (P = 100). The 'f32' mode runs plain fp32 FMAs (no TF32): 67 TFLOP/s of
// fp32 units against 3.35 TB/s, so it is bound by the fp32 units. The
// 'bf16' mode rounds the operands to bf16 and accumulates in f32; its bound
// counts the bf16 tensor-core rate (989 TFLOP/s), which puts it on the
// memory line. This kernel still computes all P^2 pairs of a symmetric
// block (twice the work the bound counts); skipping the mirrored half is
// later work.
//
// Design (simple and right first): one block of 256 threads per
// realization and pair tile. The block streams T through shared memory in
// tiles of 32 TOAs, each thread fetching its share of the next tile into
// registers while the current one is multiplied (so the global loads'
// latency overlaps the products), accumulates its (16 MT)^2 correlation
// tile in registers (MT x MT per thread: register tiling lifts the
// FMA:load ratio to MT/2 per shared load), then applies the weight slots in
// the epilogue and reduces each slot in a fixed order. Both modes multiply
// on the fp32 units. The residual is read exactly once; the weights come
// through L2. Arrays wider than 128 pulsars tile the pair space over grid.y
// and add the tiles in a fixed-order second pass. There is no float
// atomic: reruns are bit-identical. Tensor cores (wgmma) and TMA are later
// work.
#include "corr_common.cuh"

namespace fpt {

// DUAL: the column pulsars come from their own rows (res_f, or another pair
// tile); without it the block correlates its row tile with itself.
template <int MT, bool DUAL>
__global__ void __launch_bounds__(GROUP)
binned_corr_kernel(const float* __restrict__ res_l,
                   const float* __restrict__ res_f,
                   const float* __restrict__ w, float* __restrict__ out,
                   float* __restrict__ partial, int PL, int PF, int T,
                   int NB, int bf16, int ntf) {
  extern __shared__ float smem[];
  constexpr int TILE = TDIM * MT;
  constexpr int LD = TILE + 1;
  constexpr int PER = TILE * TT / GROUP;   // tile elements per thread
  float* A = smem;                    // [TT][LD] row pulsars
  float* B = smem + TT * LD;          // [TT][LD] column pulsars (DUAL)
  float* red = smem + 2 * TT * LD;    // [NB][GROUP_WARPS]

  const int r = blockIdx.x;
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * TILE, col0 = tj * TILE;
  const int nrows = min(TILE, PL - row0), ncols = min(TILE, PF - col0);
  const int tid = threadIdx.x, ty = tid / TDIM, tx = tid % TDIM;

  const float* xl = res_l + ((size_t)r * PL + row0) * T;
  const float* xf = res_f + ((size_t)r * PF + col0) * T;

  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;

  // a thread's PER tile elements: coalesced along t, all loads in flight
  // together, zero past the edges; the next tile is fetched into registers
  // while the current one is multiplied out of shared memory
  float ra[PER], rb[DUAL ? PER : 1];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * GROUP, p = e / TT, t = t0 + e % TT;
      ra[k] = (p < nrows && t < T) ? xl[(size_t)p * T + t] : 0.f;
      if (DUAL) rb[k] = (p < ncols && t < T) ? xf[(size_t)p * T + t] : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * GROUP, p = e / TT, t = e % TT;
      A[t * LD + p] = bf16 ? round_bf16(ra[k]) : ra[k];
      if (DUAL) B[t * LD + p] = bf16 ? round_bf16(rb[k]) : rb[k];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < T; t0 += TT) {
    stage();
    __syncthreads();
    if (t0 + TT < T) fetch(t0 + TT);
    corr_tile<MT>(A, DUAL ? B : A, LD, ty, tx, acc);
    __syncthreads();
  }
  float* dst = ntiles == 1 ? out + (size_t)r * NB
                           : partial + ((size_t)r * ntiles + tile) * NB;
  bin_group<MT>(acc, w, NB, PL, PF, row0, col0, nrows, ncols, ty, tx, tid,
                red, dst);
}

template <int MT>
int launch(const float* res_l, const float* res_f, const float* w, float* out,
           float* partial, int R, int PL, int PF, int T, int NB, int bf16,
           int shared, cudaStream_t stream) {
  constexpr int TILE = TDIM * MT;
  const int ntl = (PL + TILE - 1) / TILE, ntf = (PF + TILE - 1) / TILE;
  const size_t smem = (size_t)(2 * TT * (TILE + 1) + NB * GROUP_WARPS) *
                      sizeof(float);
  const dim3 grid((unsigned)R, (unsigned)(ntl * ntf));
  // one pair tile of one shared operand: correlate the tile with itself
  const bool dual = !(shared && ntl * ntf == 1);
  auto kernel = dual ? binned_corr_kernel<MT, true>
                     : binned_corr_kernel<MT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, GROUP, smem, stream>>>(res_l, res_f, w, out, partial, PL,
                                        PF, T, NB, bf16, ntf);
  if (ntl * ntf > 1) launch_reduce(partial, out, R, ntl * ntf, NB, stream);
  return 0;
}

}  // namespace fpt

// C entry: res_l (R, PL, T), res_f (R, PF, T), w (NB, PL, PF), out (R, NB),
// all float32 and contiguous; partial (R, ntiles, NB) scratch when the pair
// space needs more than one tile of 16*mt pulsars a side, else null.
// Returns cudaGetLastError() after the launch(es).
extern "C" int fpt_binned_corr(const void* res_l, const void* res_f,
                               const void* w, void* out, void* partial,
                               int R, int PL, int PF, int T, int NB, int mt,
                               int bf16, int shared, void* stream) {
  using namespace fpt;
  const float* a = static_cast<const float*>(res_l);
  const float* b = static_cast<const float*>(res_f);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (mt) {
    case 1: rc = launch<1>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 2: rc = launch<2>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 3: rc = launch<3>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 4: rc = launch<4>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 5: rc = launch<5>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 6: rc = launch<6>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 7: rc = launch<7>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 8: rc = launch<8>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
