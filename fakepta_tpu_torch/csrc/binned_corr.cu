// Fused correlation + angular binning for Hopper (sm_90a), in both of the
// TPU kernel's binning variants.
//
// Replaces the TPU kernel fakepta_tpu/ops/pallas_kernels.py::
// binned_correlation: fpt_binned_corr its MXU-binning variant (kernel body
// _binned_corr_kernel_mxu, pallas_call at pallas_kernels.py:205),
// fpt_binned_corr_vpu its mxu_binning=False variant (kernel body
// _binned_corr_kernel, pallas_call at pallas_kernels.py:223). Per
// realization r, both compute:
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
// FMA:load ratio to MT/2 per shared load). Both modes multiply on the fp32
// units. The residual is read exactly once; the weights come through L2.
// The two variants differ only in the epilogue (the Epi template
// parameter):
//   REGISTER (MXU binning): each thread applies the weight slots to its own
//     register tile, then each slot reduces in a fixed order;
//   BLOCK (mxu_binning=False): the tile is stored to shared memory as a
//     [rows][cols + 1] block and each slot n runs as ONE block-wide
//     reduction over it (the TPU variant's nbins+1 `jnp.sum(corr * w[n])`):
//     thread k sums the elements k, k + 256, ... times w[n] (consecutive
//     threads on consecutive columns, so the weight reads coalesce), a fixed
//     shuffle tree folds each warp, and thread n adds the warp sums in warp
//     order.
// Arrays wider than 128 pulsars tile the pair space over grid.y and add the
// tiles in a fixed-order second pass. There is no float atomic: reruns are
// bit-identical. Tensor cores (wgmma) and TMA are later work.
#include "corr_common.cuh"

namespace fpt {

enum class Epi { REGISTER, BLOCK };

// Block-wide binning of the tile C ([nrows][LD] in shared memory):
// dst[n] = sum_{p,q} C[p][q] w[n, row0 + p, col0 + q], one fixed-order
// reduction per slot.
template <int LD>
__device__ void bin_block(const float* C, const float* __restrict__ w, int NB,
                          int PL, int PF, int row0, int col0, int nrows,
                          int ncols, int tid, float* red, float* dst) {
  const int warp = tid >> 5, lane = tid & 31;
  const int n_el = nrows * ncols;
  for (int n = 0; n < NB; ++n) {
    const float* wn = w + (size_t)n * PL * PF + (size_t)row0 * PF + col0;
    float s = 0.f;
    for (int e = tid; e < n_el; e += GROUP) {
      const int p = e / ncols, q = e - p * ncols;
      s = fmaf(C[p * LD + q], wn[(size_t)p * PF + q], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[n * GROUP_WARPS + warp] = s;
  }
  __syncthreads();
  for (int n = tid; n < NB; n += GROUP) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < GROUP_WARPS; ++k) s += red[n * GROUP_WARPS + k];
    dst[n] = s;
  }
}

// DUAL: the column pulsars come from their own rows (res_f, or another pair
// tile); without it the block correlates its row tile with itself.
template <int MT, bool DUAL, Epi EPI>
__global__ void __launch_bounds__(GROUP)
binned_corr_kernel(const float* __restrict__ res_l,
                   const float* __restrict__ res_f,
                   const float* __restrict__ w, float* __restrict__ out,
                   float* __restrict__ partial, int PL, int PF, int T,
                   int NB, int bf16, int ntf) {
  extern __shared__ float smem[];
  constexpr int TILE = TDIM * MT;
  constexpr int LD = TILE + 1;
  float* A = smem;                    // [TT][LD] row pulsars
  float* B = smem + TT * LD;          // [TT][LD] column pulsars (DUAL)
  float* C = smem + 2 * TT * LD;      // [TILE][LD] the tile (BLOCK only)
  float* red = EPI == Epi::BLOCK ? C + TILE * LD : C;  // [NB][GROUP_WARPS]

  const int r = blockIdx.x;
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * TILE, col0 = tj * TILE;
  const int nrows = min(TILE, PL - row0), ncols = min(TILE, PF - col0);
  const int tid = threadIdx.x, ty = tid / TDIM, tx = tid % TDIM;

  float acc[MT][MT];
  accumulate_block<MT, DUAL>(res_l + ((size_t)r * PL + row0) * T,
                             res_f + ((size_t)r * PF + col0) * T, T, nrows,
                             ncols, bf16, A, B, acc);
  float* dst = ntiles == 1 ? out + (size_t)r * NB
                           : partial + ((size_t)r * ntiles + tile) * NB;
  if constexpr (EPI == Epi::REGISTER) {
    bin_group<MT>(acc, w, NB, PL, PF, row0, col0, nrows, ncols, ty, tx, tid,
                  red, dst);
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        C[(ty + TDIM * i) * LD + tx + TDIM * j] = acc[i][j];
    __syncthreads();
    bin_block<LD>(C, w, NB, PL, PF, row0, col0, nrows, ncols, tid, red, dst);
  }
}

template <int MT, Epi EPI>
int launch(const float* res_l, const float* res_f, const float* w, float* out,
           float* partial, int R, int PL, int PF, int T, int NB, int bf16,
           int shared, cudaStream_t stream) {
  constexpr int TILE = TDIM * MT;
  constexpr int LD = TILE + 1;
  const int ntl = (PL + TILE - 1) / TILE, ntf = (PF + TILE - 1) / TILE;
  const size_t smem = (size_t)(2 * TT * LD + (EPI == Epi::BLOCK ? TILE * LD
                                                                : 0) +
                               NB * GROUP_WARPS) * sizeof(float);
  const dim3 grid((unsigned)R, (unsigned)(ntl * ntf));
  // one pair tile of one shared operand: correlate the tile with itself
  const bool dual = !(shared && ntl * ntf == 1);
  auto kernel = dual ? binned_corr_kernel<MT, true, EPI>
                     : binned_corr_kernel<MT, false, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, GROUP, smem, stream>>>(res_l, res_f, w, out, partial, PL,
                                        PF, T, NB, bf16, ntf);
  if (ntl * ntf > 1) launch_reduce(partial, out, R, ntl * ntf, NB, stream);
  return 0;
}

template <Epi EPI>
int dispatch(const void* res_l, const void* res_f, const void* w, void* out,
             void* partial, int R, int PL, int PF, int T, int NB, int mt,
             int bf16, int shared, void* stream) {
  const float* a = static_cast<const float*>(res_l);
  const float* b = static_cast<const float*>(res_f);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (mt) {
    case 1: rc = launch<1, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 2: rc = launch<2, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 3: rc = launch<3, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 4: rc = launch<4, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 5: rc = launch<5, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 6: rc = launch<6, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 7: rc = launch<7, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    case 8: rc = launch<8, EPI>(a, b, wp, o, part, R, PL, PF, T, NB, bf16, shared, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace fpt

// C entries, one per binning variant, with one contract: res_l (R, PL, T),
// res_f (R, PF, T), w (NB, PL, PF), out (R, NB), all float32 and
// contiguous; partial (R, ntiles, NB) scratch when the pair space needs more
// than one tile of 16*mt pulsars a side, else null. Return
// cudaGetLastError() after the launch(es).
extern "C" int fpt_binned_corr(const void* res_l, const void* res_f,
                               const void* w, void* out, void* partial,
                               int R, int PL, int PF, int T, int NB, int mt,
                               int bf16, int shared, void* stream) {
  return fpt::dispatch<fpt::Epi::REGISTER>(res_l, res_f, w, out, partial, R,
                                           PL, PF, T, NB, mt, bf16, shared,
                                           stream);
}

extern "C" int fpt_binned_corr_vpu(const void* res_l, const void* res_f,
                                   const void* w, void* out, void* partial,
                                   int R, int PL, int PF, int T, int NB,
                                   int mt, int bf16, int shared,
                                   void* stream) {
  return fpt::dispatch<fpt::Epi::BLOCK>(res_l, res_f, w, out, partial, R, PL,
                                        PF, T, NB, mt, bf16, shared, stream);
}
