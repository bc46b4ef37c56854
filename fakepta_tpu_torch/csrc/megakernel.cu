// Whole-chunk statistic kernel for Hopper (sm_90a): GP projection with
// on-chip Fourier bases, correlation and angular binning in one pass.
//
// Replaces the TPU kernel fakepta_tpu/ops/megakernel.py::chunk_stats on
// both its operand sets (kernel body _mega_kernel with
// _project_rows/_basis_rows, pallas_call at megakernel.py:399): the shared
// set (base_local=None, one shard holds every pulsar) and the local+full set
// of a psr shard (shared=False, megakernel.py:149-157,384-397). Per
// realization r and TOA t, on each set:
//   res[p, t] = base[r, p, t] + sum_k coef[r, p, k] B_k(p, t)
//   B rows    = cosf((2 pi t_norm) n) s, n = 1..nbin, then sinf(...) s,
//               per stage (nbin, time row, scale row), as _basis_rows builds
//   out[r, n] = sum_pq (res_l res_f^T)[p, q] w[n, p, q]
// where res_l is the shard's PL rows (the local set) and res_f the PF rows
// of the gathered array (the full set); on the shared set both are the one
// array. The dense (P, T, K) basis and the projected residuals never exist
// in device memory: it reads base and coef, the small time and scale tables
// and the weights, and writes (R, NB). Like the TPU kernel, a shard
// recomputes the full rows from the gathered coefficients instead of
// gathering projected residuals.
//
// What bounds it on an H100: chunk_bytes_model(mode='mega') counts the
// base and coefficient bytes twice (written by the draws, read here); this
// kernel's own traffic is one read of each, R P (T + K) 4 bytes at f32 and
// half that under bf16 storage. Its work is 2 R P K T FLOPs of projection
// plus R P (P+1) T of correlation (the block is symmetric: P(P+1)/2
// distinct pairs; 59 GFLOP per 1024-realization flagship chunk, K = 320) on
// the fp32 units, plus P T K / 2 sine-cosine pairs per realization tile: it
// is bound by operations, not bytes. Like binned_corr.cu it still computes
// all P^2 pairs of the symmetric block.
//
// On the local+full set the work is 2 R (PL + PF) K T projection FLOPs and
// 2 R PL PF T correlation FLOPs (no symmetry), on R (PL + PF) (T + K)
// elements read.
//
// Design (simple and right first): a block takes RT = 2 realizations, 256
// threads each, and one pair tile: row pulsars from the local set, column
// pulsars from the full set (the two tiles are one on the shared set's
// diagonal). For every tile of 32 TOAs, each warp takes one pulsar at a
// time, evaluates its basis values once (sincosf, accurate: no fast math)
// and applies them to both realizations' coefficients, adds the base and
// stores the residual tile in shared memory; each 256-thread group then
// accumulates its realization's correlation tile in registers as in
// binned_corr.cu and bins it in a fixed order in the epilogue. RT is the
// number of realizations whose correlation tile fits the register file at
// once; a larger RT amortizes the sine-cosine work further (later work,
// with tensor cores for the two products). No float atomics: reruns are
// bit-identical.
#include "corr_common.cuh"

namespace fpt {

constexpr int RT = 2;           // realizations per block
constexpr int MAX_STAGES = 16;

struct Stages {
  int n;
  int nbin[MAX_STAGES];
  int tcol[MAX_STAGES];
  int scol[MAX_STAGES];
  int k0[MAX_STAGES];
};

// One operand set: base (R, P, T), coef (R, P, K), times (2, P, T) and
// scales (S, P, T).
template <typename TS>
struct Operands {
  const TS* base;
  const TS* coef;
  const float* times;
  const float* scales;
  int P;
};

// Residual rows [row0, row0 + nrows) of operand set `op` for the block's
// realizations and the TOA tile at t0, rounded to bf16 when asked, stored
// [rr][t][p] in dst.
template <int MT, typename TS>
__device__ void project_tile(const Operands<TS>& op, const Stages& st,
                             float* dst, int r0, int R, int T, int K,
                             int row0, int nrows, int t0, int bf16) {
  const TS* __restrict__ base = op.base;
  const TS* __restrict__ coef = op.coef;
  const float* __restrict__ times = op.times;
  const float* __restrict__ scales = op.scales;
  const int P = op.P;
  constexpr int TILE = TDIM * MT;
  constexpr int LD = TILE + 1;
  const float two_pi = 6.28318530717958647692f;
  for (int e = threadIdx.x; e < TILE * TT; e += RT * GROUP) {
    const int p = e / TT, t = e % TT;
    const int tg = t0 + t, pg = row0 + p;
    const bool valid = p < nrows && tg < T;
    float acc[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.f;
    if (valid) {
      for (int s = 0; s < st.n; ++s) {
        const int nbin = st.nbin[s];
        const float tv = times[((size_t)st.tcol[s] * P + pg) * T + tg];
        const float sv = scales[((size_t)st.scol[s] * P + pg) * T + tg];
        const float tw = two_pi * tv;
        for (int n = 1; n <= nbin; ++n) {
          float sn, cs;
          sincosf(tw * (float)n, &sn, &cs);
          const float bc = cs * sv, bs = sn * sv;
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            const int r = min(r0 + rr, R - 1);
            const TS* c = coef + ((size_t)r * P + pg) * K + st.k0[s];
            acc[rr] = fmaf(load_f(c + n - 1), bc, acc[rr]);
            acc[rr] = fmaf(load_f(c + nbin + n - 1), bs, acc[rr]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      float v = 0.f;
      if (valid && r0 + rr < R)
        v = load_f(base + ((size_t)(r0 + rr) * P + pg) * T + tg) + acc[rr];
      dst[(rr * TT + t) * LD + p] = bf16 ? round_bf16(v) : v;
    }
  }
}

template <int MT, typename TS>
__global__ void __launch_bounds__(RT * GROUP, 1)
mega_kernel(Operands<TS> loc, Operands<TS> full,
            const float* __restrict__ w, Stages st, float* __restrict__ out,
            float* __restrict__ partial, int R, int T, int K, int NB,
            int bf16, int ntf, int shared) {
  extern __shared__ float smem[];
  constexpr int TILE = TDIM * MT;
  constexpr int LD = TILE + 1;
  float* rows = smem;                       // [RT][TT][LD]
  float* cols = smem + RT * TT * LD;        // [RT][TT][LD] (off-diagonal)
  float* red = smem + 2 * RT * TT * LD;     // [RT][NB][GROUP_WARPS]

  const int r0 = blockIdx.x * RT;
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * TILE, col0 = tj * TILE;
  const int PL = loc.P, PF = full.P;
  const int nrows = min(TILE, PL - row0), ncols = min(TILE, PF - col0);
  const bool same = shared && ti == tj;
  const int g = threadIdx.x / GROUP, gtid = threadIdx.x % GROUP;
  const int ty = gtid / TDIM, tx = gtid % TDIM;

  float acc[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < T; t0 += TT) {
    project_tile<MT, TS>(loc, st, rows, r0, R, T, K, row0, nrows, t0, bf16);
    if (!same)
      project_tile<MT, TS>(full, st, cols, r0, R, T, K, col0, ncols, t0,
                           bf16);
    __syncthreads();
    const float* A = rows + g * TT * LD;
    const float* B = (same ? rows : cols) + g * TT * LD;
    corr_tile<MT>(A, B, LD, ty, tx, acc);
    __syncthreads();
  }
  const int r = r0 + g;
  float* dst = nullptr;
  if (r < R)
    dst = ntiles == 1 ? out + (size_t)r * NB
                      : partial + ((size_t)r * ntiles + tile) * NB;
  bin_group<MT>(acc, w, NB, PL, PF, row0, col0, nrows, ncols, ty, tx, gtid,
                red + g * NB * GROUP_WARPS, dst);
}

template <int MT, typename TS>
int launch(const Operands<TS>& loc, const Operands<TS>& full, const float* w,
           const Stages& st, float* out, float* partial, int R, int T, int K,
           int NB, int bf16, int shared, cudaStream_t stream) {
  constexpr int TILE = TDIM * MT;
  const int ntl = (loc.P + TILE - 1) / TILE;
  const int ntf = (full.P + TILE - 1) / TILE;
  const size_t smem =
      (size_t)(2 * RT * TT * (TILE + 1) + RT * NB * GROUP_WARPS) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mega_kernel<MT, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + RT - 1) / RT), (unsigned)(ntl * ntf));
  mega_kernel<MT, TS><<<grid, RT * GROUP, smem, stream>>>(
      loc, full, w, st, out, partial, R, T, K, NB, bf16, ntf, shared);
  if (ntl * ntf > 1) launch_reduce(partial, out, R, ntl * ntf, NB, stream);
  return 0;
}

template <typename TS>
int dispatch(const void* const* ptrs, int PL, int PF, const float* w,
             const Stages& st, float* out, float* partial, int R, int T,
             int K, int NB, int mt, int bf16, int shared, cudaStream_t s) {
  const Operands<TS> loc{static_cast<const TS*>(ptrs[0]),
                         static_cast<const TS*>(ptrs[1]),
                         static_cast<const float*>(ptrs[2]),
                         static_cast<const float*>(ptrs[3]), PL};
  const Operands<TS> full{static_cast<const TS*>(ptrs[4]),
                          static_cast<const TS*>(ptrs[5]),
                          static_cast<const float*>(ptrs[6]),
                          static_cast<const float*>(ptrs[7]), PF};
  switch (mt) {
    case 1: return launch<1, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 2: return launch<2, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 3: return launch<3, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 4: return launch<4, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 5: return launch<5, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 6: return launch<6, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 7: return launch<7, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    case 8: return launch<8, TS>(loc, full, w, st, out, partial, R, T, K, NB, bf16, shared, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fpt

// C entry. The local set base_l (R, PL, T), coef_l (R, PL, K), times_l
// (2, PL, T), scales_l (S, PL, T) and the full set base_f (R, PF, T),
// coef_f (R, PF, K), times_f (2, PF, T), scales_f (S, PF, T): base and coef
// float32 (store_bf16 = 0) or bfloat16 (store_bf16 = 1), the tables float32.
// shared = 1 passes the same arrays as both sets (PL = PF). w (NB, PL, PF)
// and out (R, NB) float32; all contiguous. Stage s covers coef columns
// [k0[s], k0[s] + 2 nbin[s]) (cos rows then sin rows). partial is
// (R, ntiles, NB) scratch when the pair space needs more than one tile of
// 16*mt pulsars a side, else null. Returns cudaGetLastError() after the
// launch(es).
extern "C" int fpt_chunk_stats(const void* base_l, const void* coef_l,
                               const void* times_l, const void* scales_l,
                               const void* base_f, const void* coef_f,
                               const void* times_f, const void* scales_f,
                               const void* w, void* out, void* partial,
                               int R, int PL, int PF, int T, int K, int NB,
                               int n_stages, const int* nbin,
                               const int* tcol, const int* scol, int mt,
                               int store_bf16, int bf16, int shared,
                               void* stream) {
  using namespace fpt;
  if (n_stages < 0 || n_stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  if (shared && PL != PF) return (int)cudaErrorInvalidValue;
  Stages st;
  st.n = n_stages;
  int k0 = 0;
  for (int s = 0; s < MAX_STAGES; ++s) {
    const bool live = s < n_stages;
    st.nbin[s] = live ? nbin[s] : 0;
    st.tcol[s] = live ? tcol[s] : 0;
    st.scol[s] = live ? scol[s] : 0;
    st.k0[s] = k0;
    k0 += 2 * st.nbin[s];
  }
  if (k0 != K) return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {base_l, coef_l, times_l, scales_l,
                         base_f, coef_f, times_f, scales_f};
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      store_bf16
          ? dispatch<__nv_bfloat16>(ptrs, PL, PF, wp, st, o, part, R, T, K,
                                    NB, mt, bf16, shared, s)
          : dispatch<float>(ptrs, PL, PF, wp, st, o, part, R, T, K, NB, mt,
                            bf16, shared, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
