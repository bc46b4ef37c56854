// GP projection for Hopper (sm_90a): pass 1 of the port's whole-chunk
// statistic, ops/megakernel.py::chunk_stats.
//
// Replaces, with binned_corr.cu's fpt_binned_corr as pass 2, the TPU kernel
// fakepta_tpu/ops/megakernel.py::chunk_stats on both its operand sets
// (kernel body _mega_kernel with _project_rows/_basis_rows, pallas_call at
// megakernel.py:399): the shared set (base_local=None, one shard holds every
// pulsar) and the local+full set of a psr shard (shared=False,
// megakernel.py:149-157,384-397). Per realization r, pulsar p and TOA t of
// each set's rows:
//   res[r, p, t] = base[r, p, t] + sum_k coef[r, p, k] B_k(p, t)
//   B rows       = cosf((2 pi t_norm) n) s, n = 1..nbin, then sinf(...) s,
//                  per stage (nbin, time row, scale row), as _basis_rows
//                  builds them
// Pass 2 (fpt_binned_corr, launched by the wrapper on the same stream)
// correlates the local rows against the full rows and bins them.
//
// Why two passes. The TPU kernel keeps the residuals in VMEM because a v5e
// is bound by HBM. On an H100 the residuals' round trip costs R (PL + PF) T
// 4 bytes, written here and read by pass 2 (2 x 320 MB, ~0.19 ms at
// 3.35 TB/s for the flagship shared set), while keeping them on chip beside
// a realization's 100 x 100 fp32 correlation block (40 KB of registers)
// caps a block at 2-4 realizations, and then each basis value is rebuilt
// hundreds of times. Here a block projects BM = 128 realizations, so each
// basis value is built once per 128 realizations.
//
// What bounds pass 1: 2 R rows K T FLOPs, three times over on the TF32
// tensor cores (3xTF32; twice under bf16 storage): 153 GFLOP, 0.31 ms at
// 495 TFLOP/s, for the flagship shared set (R = 1024, 100 rows, K = 320, T = 780), against
// base + coef + res = 320 + 131 + 320 MB, 0.23 ms at 3.35 TB/s: the
// products, then the bytes; plus (R / BM) rows T K / 2 accurate sincosf on
// the fp32 units.
//
// Design.
//   Blocks. Per pulsar the projection is a GEMM: M = realizations, N = TOAs,
//     K = basis columns. A block takes BM realizations x BN TOAs of one
//     pulsar row; the grid is (ceil(R / BM), ceil(T / BN), rows), rows the
//     set's P on the shared set and PL local rows then PF full rows on the
//     local+full set (both projected, as the TPU kernel does). 8 warps in a
//     WGM x (8 / WGM) grid each own FM x FN m16n8 fragments; two blocks per
//     SM. The source instantiates one tile, FPT_PROJ_TILES: 128 x 128,
//     1.10-1.12x faster than 128 x 64 and 1.4x faster than 64 x 64 at the
//     flagship shapes (tools/megakernel_variants.py, which builds the
//     others): fewer coef re-reads per TOA and fewer basis builds per
//     realization.
//   Harmonic chunks. K is consumed NH harmonic slots at a time, the slots of
//     all stages in order (a chunk may straddle two stages; the last is
//     zero-padded): KC = 2 NH columns, the chunk's NH cos columns then its
//     NH sin columns. The block stages the matching coef columns of its BM
//     realizations ([m][k], row stride KC + 4 = 4 mod 32, so the A-fragment
//     loads stay on 32 banks) and builds the chunk's basis tile ([k][t],
//     row stride BN + 8 = 8 mod 32): one accurate sincosf of the reference's
//     f32 phase (2 pi t) n gives the cos and the sin value. The block's time
//     rows (times 2 pi) and scale rows sit in shared memory; padding TOAs
//     have scale 0, so their basis is 0.
//   Products: mma.sync.aligned.m16n8k8 TF32, 3xTF32 (the projection is f32
//     in both modes, the reference's Precision.HIGHEST): hi =
//     cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), split once at staging;
//     per k-step hi.lo + lo.hi + hi.hi summed from zero, then joined to the
//     fp32 accumulator with an IEEE add (chaining the passes in the tensor
//     core's truncating accumulator came within 1.4x of the 1e-5 tolerance
//     in binned_corr.cu). Under bf16 storage coef is exact in TF32 (8
//     significant bits of TF32's 11): its lo part is 0, so the coef.lo
//     product is left out at compile time and pass 1 makes two passes.
//   Epilogue: the accumulators go through shared memory (the staging tiles'
//     room), and each row of BN TOAs adds base (bf16 -> f32 under bf16
//     storage) and is written as f32, consecutive threads on consecutive
//     TOAs.
//   With no stage (K = 0) the kernel only converts base to f32.
//
// On a float64 batch (fpt_project_f64; pass 2 is binned_corr.cu's
// fpt_binned_corr_f64, or fpt_binned_corr under bf16 storage), as the TPU
// kernel computes at float64 (its cdtype is the batch's):
//   'f32': project_f64_kernel (its design, a pipelined mainloop, is beside
//     it), float64 throughout on the FP64 tensor cores (DMMA): the basis
//     from float64 sincos of the float64 phase (2 pi t) n, the projection
//     at float64, float64 residuals. What bounds it on the flagship shared
//     set: 2 R rows K T = 51.1 GFLOP, 0.76 ms at the FP64 tensor cores' 67
//     TFLOP/s, against base + coef + res = 639 + 262 + 639 MB, 0.46 ms at
//     3.35 TB/s: the products; plus (R / BM) rows T K / 2 = 1.0e8 float64
//     sincos at BM = 128, on the FP64 units beside the DMMAs.
//   'bf16' (bf16 storage): the TPU kernel's cdtype is float32, but its
//     float64 time and scale tables promote the phase and the basis to
//     float64, which its float32 product then rounds to float32. So
//     project_kernel runs as on a float32 batch (3xTF32, two products, float32
//     residuals) with only the basis built otherwise: float64 sincos of the
//     float64 phase, times the float64 scale, rounded once to float32
//     (basis_pair).
// Every sum runs in a fixed order and no float atomic is used: reruns are
// bit-identical.
#include <cstdint>
#include <type_traits>

#include "corr_common.cuh"

namespace fpt {

constexpr int MAX_STAGES = 16;
constexpr int PROJ_WARPS = 8;
constexpr int PROJ_THREADS = 32 * PROJ_WARPS;
constexpr int PROJ_BLOCKS = 2;   // blocks per SM (launch bounds)
constexpr int NH = 16;           // harmonic slots per chunk
constexpr int KC = 2 * NH;       // basis columns per chunk
constexpr int LDA = KC + 4;      // coef tile row stride, = 4 (mod 32)

struct Stages {
  int n;
  int nbin[MAX_STAGES];
  int tcol[MAX_STAGES];
  int scol[MAX_STAGES];
  int k0[MAX_STAGES];
};

// One operand set: base (R, P, T), coef (R, P, K) at the storage type TS,
// times (2, P, T) and scales (S, P, T) at the tables' type TB.
template <typename TS, typename TB = float>
struct Operands {
  const TS* base;
  const TS* coef;
  const TB* times;
  const TB* scales;
  int P;
};

// Shared-memory floats of a (BM, BN) block with S scale rows: the staging
// tiles or the epilogue's accumulator tile, whichever is larger, then the
// time and scale rows (tb floats a value: 1 for float32 tables, 2 for
// float64). ops/megakernel.py::project_smem mirrors it.
__host__ __device__ constexpr int proj_tile_floats(int bm, int bn) {
  return 2 * bm * LDA + 2 * KC * (bn + 8) > bm * (bn + 8)
             ? 2 * bm * LDA + 2 * KC * (bn + 8)
             : bm * (bn + 8);
}

__host__ __device__ constexpr int proj_floats(int bm, int bn, int S,
                                              int tb = 1) {
  return proj_tile_floats(bm, bn) + (2 + S) * bn * tb;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a b: one m16n8k8 TF32 product, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as its TF32 hi part at dst[0] and lo part at dst[lo]
__device__ __forceinline__ void store_split(float* dst, int lo, float x) {
  const uint32_t hi = to_tf32(x);
  dst[0] = __uint_as_float(hi);
  dst[lo] = __uint_as_float(to_tf32(x - __uint_as_float(hi)));
}

// A basis pair (cos, sin) of harmonic n at one TOA: tw is the TOA's 2 pi t,
// sv its scale. float32 tables: one accurate sincosf of the float32 phase
// (the reference's, float32 throughout). float64 tables (bf16 storage of a
// float64 batch, whose reference computes at float32 but promotes the phase
// with its float64 tables): sincos of the float64 phase, times the scale at
// float64, each rounded once to float32.
__device__ __forceinline__ void basis_pair(float tw, int n, float sv,
                                           float& bc, float& bs) {
  float sn, cs;
  sincosf(tw * (float)n, &sn, &cs);
  bc = cs * sv;
  bs = sn * sv;
}
__device__ __forceinline__ void basis_pair(double tw, int n, double sv,
                                           float& bc, float& bs) {
  double sn, cs;
  sincos(tw * (double)n, &sn, &cs);
  bc = (float)(cs * sv);
  bs = (float)(sn * sv);
}

// The stage s and harmonic index n (0-based) of the harmonic slot that lies
// `h` slots past (s, n); s = st.n past the last slot.
__device__ __forceinline__ void walk(const Stages& st, int& s, int& n, int h) {
  n += h;
  while (s < st.n && n >= st.nbin[s]) {
    n -= st.nbin[s];
    ++s;
  }
}

// Fragment layouts (PTX ISA, m16n8k8 .tf32), g = lane >> 2, k = lane & 3:
//   A (16 x 8, row): a0 (g, k), a1 (g + 8, k), a2 (g, k + 4), a3 (g + 8, k + 4)
//   B (8 x 8, col):  b0 (k, g), b1 (k + 4, g)
//   C (16 x 8):      c0 (g, 2k), c1 (g, 2k + 1), c2 (g + 8, 2k),
//                    c3 (g + 8, 2k + 1)
// A[m][k] is realization m's coefficient of chunk column k (As, [m][k]);
// B[k][n] is column k's basis value at TOA n (Bs, [k][n]).
template <int BM, int BN, int WGM, typename TS, typename TB = float>
__global__ void __launch_bounds__(PROJ_THREADS, PROJ_BLOCKS)
project_kernel(Operands<TS, TB> loc, Operands<TS, TB> full, Stages st,
               float* __restrict__ res_l, float* __restrict__ res_f, int R,
               int T, int K, int S, int nloc) {
  constexpr int WGN = PROJ_WARPS / WGM;
  constexpr int FM = BM / (16 * WGM), FN = BN / (8 * WGN);
  constexpr int LDB = BN + 8;   // = 8 (mod 32)
  constexpr int LDC = BN + 8;
  static_assert(FM * 16 * WGM == BM && FN * 8 * WGN == BN, "warp grid");
  static_assert(PROJ_THREADS % BN == 0 && PROJ_THREADS % KC == 0, "lanes");
  // coef stored in bfloat16 is exact in TF32: no lo part, no lo product
  constexpr bool EXACT_A = std::is_same<TS, __nv_bfloat16>::value;
  extern __shared__ float smem[];
  float* As = smem;                      // [2][BM][LDA]: hi, lo (unused
                                         // under EXACT_A)
  float* Bs = smem + 2 * BM * LDA;       // [2][KC][LDB]: hi, lo
  float* Cs = smem;                      // [BM][LDC], after the mainloop
  TB* rows = reinterpret_cast<TB*>(smem + proj_tile_floats(BM, BN));
                                         // [2 + S][BN]

  const int z = blockIdx.z;
  const bool is_loc = z < nloc;
  const int p = is_loc ? z : z - nloc;
  const int P = is_loc ? loc.P : full.P;
  const TS* __restrict__ base = is_loc ? loc.base : full.base;
  const TS* __restrict__ coef = is_loc ? loc.coef : full.coef;
  const TB* __restrict__ times = is_loc ? loc.times : full.times;
  const TB* __restrict__ scales = is_loc ? loc.scales : full.scales;
  float* __restrict__ out = is_loc ? res_l : res_f;
  const int r0 = blockIdx.x * BM, t0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % WGM, wn = warp / WGM;

  // the block's time rows (times 2 pi, 2 pi rounded to f32 as the
  // reference rounds it, the product at the tables' type) and scale rows;
  // 0 past T
  const float two_pi = 6.28318530717958647692f;
  for (int e = tid; e < (2 + S) * BN; e += PROJ_THREADS) {
    const int row = e / BN, t = t0 + e % BN;
    TB v = 0;
    if (t < T)
      v = row < 2 ? (TB)two_pi * times[((size_t)row * P + p) * T + t]
                  : scales[((size_t)(row - 2) * P + p) * T + t];
    rows[e] = v;
  }
  __syncthreads();

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // Staging roles, fixed for the whole loop: the thread stages column aj of
  // the coef tile for rows tid / KC + m (PROJ_THREADS / KC) and builds the
  // basis at TOA bt for slots tid / BN + h (PROJ_THREADS / BN).
  const int aj = tid % KC, bt = tid % BN;
  const bool a_sin = aj >= NH;
  int s0 = 0, n0 = 0;   // the chunk's first slot (block-uniform)
  for (int q0 = 0; 2 * q0 < K; q0 += NH) {
    {
      int s = s0, n = n0;
      walk(st, s, n, aj % NH);
      const bool live = s < st.n;
      const int col = live ? st.k0[s] + (a_sin ? st.nbin[s] : 0) + n : 0;
      for (int m = tid / KC; m < BM; m += PROJ_THREADS / KC) {
        const int r = r0 + m;
        const float v =
            live && r < R ? load_f(coef + ((size_t)r * P + p) * K + col) : 0.f;
        if (EXACT_A)
          As[m * LDA + aj] = v;
        else
          store_split(As + m * LDA + aj, BM * LDA, v);
      }
    }
    for (int h = tid / BN; h < NH; h += PROJ_THREADS / BN) {
      int s = s0, n = n0;
      walk(st, s, n, h);
      float bc = 0.f, bs = 0.f;
      if (s < st.n)
        basis_pair(rows[st.tcol[s] * BN + bt], n + 1,
                   rows[(2 + st.scol[s]) * BN + bt], bc, bs);
      store_split(Bs + h * LDB + bt, KC * LDB, bc);
      store_split(Bs + (NH + h) * LDB + bt, KC * LDB, bs);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      const float* a = As + (wm * FM * 16 + g) * LDA + ks + k4;
      uint32_t ah[FM][4], al[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int off = (16 * i + (c & 1) * 8) * LDA + (c & 2) * 2;
          ah[i][c] = __float_as_uint(a[off]);
          al[i][c] = __float_as_uint(a[BM * LDA + off]);
        }
      const float* b = Bs + (ks + k4) * LDB + wn * FN * 8 + g;
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const uint32_t h0 = __float_as_uint(b[8 * j]);
        const uint32_t h1 = __float_as_uint(b[8 * j + 4 * LDB]);
        const uint32_t l0 = __float_as_uint(b[KC * LDB + 8 * j]);
        const uint32_t l1 = __float_as_uint(b[KC * LDB + 8 * j + 4 * LDB]);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, ah[i], l0, l1);
          if (!EXACT_A) mma_tf32(d, al[i], h0, h1);
          mma_tf32(d, ah[i], h0, h1);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += d[c];
        }
      }
    }
    __syncthreads();
    walk(st, s0, n0, NH);
  }

  // epilogue: accumulators to [BM][LDC] (8-byte stores, a half-warp on 32
  // banks), then res = base + acc row by row
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int m = (wm * FM + i) * 16 + g + 8 * h;
        const int c = (wn * FN + j) * 8 + 2 * k4;
        *reinterpret_cast<float2*>(Cs + m * LDC + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += PROJ_THREADS) {
    const int m = e / BN, c = e % BN;
    const int r = r0 + m, t = t0 + c;
    if (r < R && t < T) {
      const size_t o = ((size_t)r * P + p) * T + t;
      out[o] = load_f(base + o) + Cs[m * LDC + c];
    }
  }
}

template <int BM, int BN, int WGM, typename TS, typename TB>
int launch_project(const Operands<TS, TB>& loc, const Operands<TS, TB>& full,
                   const Stages& st, float* res_l, float* res_f, int R,
                   int T, int K, int S, int nloc, int rows,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)proj_floats(BM, BN, S, sizeof(TB) / sizeof(float)) *
      sizeof(float);
  auto kernel = project_kernel<BM, BN, WGM, TS, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (unsigned)((T + BN - 1) / BN),
                  (unsigned)rows);
  kernel<<<grid, PROJ_THREADS, smem, stream>>>(loc, full, st, res_l, res_f, R,
                                               T, K, S, nloc);
  return 0;
}

// the (BM, BN, WGM) block tiles the kernel is instantiated for
// (ops/megakernel.py::PROJ_TILE)
#define FPT_PROJ_TILES(X) X(128, 128, 4)

template <typename TS, typename TB = float>
int dispatch(const void* const* ptrs, int PL, int PF, const Stages& st,
             float* res_l, float* res_f, int R, int T, int K, int S,
             int shared, int bm, int bn, int wgm, cudaStream_t stream) {
  const Operands<TS, TB> loc{static_cast<const TS*>(ptrs[0]),
                             static_cast<const TS*>(ptrs[1]),
                             static_cast<const TB*>(ptrs[2]),
                             static_cast<const TB*>(ptrs[3]), PL};
  const Operands<TS, TB> full{static_cast<const TS*>(ptrs[4]),
                              static_cast<const TS*>(ptrs[5]),
                              static_cast<const TB*>(ptrs[6]),
                              static_cast<const TB*>(ptrs[7]), PF};
  const int nloc = shared ? 0 : PL;
  const int rows = nloc + PF;
#define FPT_TILE(BM_, BN_, WGM_)                                            \
  if (bm == BM_ && bn == BN_ && wgm == WGM_)                                \
    return launch_project<BM_, BN_, WGM_, TS, TB>(                          \
        loc, full, st, res_l, res_f, R, T, K, S, nloc, rows, stream);
  FPT_PROJ_TILES(FPT_TILE)
#undef FPT_TILE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The projection at float64 on the FP64 tensor cores (fpt_project_f64,
// store_bf16 = 0): the same GEMM per pulsar, with float64 coefficients, a
// float64 basis and float64 residuals. Products mma.sync.aligned.m16n8k8
// .f64 (DMMA; the m8n8k4 shape runs at half the FP64 tensor cores' rate on
// an H100, tools/dmma_shapes.py; wgmma has no float64 form).
//
// Design: a pipelined mainloop, one barrier a stage (PERF.md's float64
// findings have the steps and the designs measured against it).
//   Blocks. A block takes BM realizations x BN TOAs of one pulsar row
//     (FPT_PROJ_F64_TILES), P64_WARPS warps in a WGM x (P64_WARPS / WGM)
//     grid each owning FM x FN m16n8 fragments, P64_BLOCKS blocks an SM,
//     so that one block's copies and sincos stand beside another's DMMAs.
//   Stages. K is consumed P64_KC columns a stage: P64_KC / 32 chunks of NH
//     harmonic slots each, the chunk's cos columns then its sin columns,
//     the slots of all stages in order (a stage may straddle GP stages; the
//     last is zero-padded): kernel_columns' order (ops/megakernel.py).
//   Rings. The coefficient tiles ([m][k]) fill a ring of P64_STAGES shared
//     stages by cp.async (8-byte copies: a chunk's columns start at any
//     column of a coef row, so they are only 8-byte aligned; zero-filled
//     past R and past the last slot), issued P64_STAGES - 1 stages ahead.
//     The basis tiles ([t][k]) fill a ring of two: the same threads build
//     stage q + 1 (one float64 sincos of the float64 phase (2 pi t) n gives
//     the cos and the sin value, times the scale; none past T) after the
//     DMMAs of stage q (built between the k-steps it kept more registers
//     live, which spill at two blocks an SM). Stage q's end waits for the
//     copies of stage q + 1 and meets one __syncthreads: stage
//     q + P64_STAGES - 1 overwrites the coef slot stage q - 1 read, stage
//     q + 1 the basis slot.
//   Epilogue. The accumulators start at 0, go to shared memory in the
//     coef ring's room, and res = base + acc is formed row by row,
//     consecutive threads on consecutive TOAs (written from the fragments,
//     8 bytes a lane, it took 0.3 ms more at the flagship).
//   Shared loads. Row stride P64_LD = P64_KC + 4 (4 mod 16 doubles): a
//     lane's fragment loads are 8 bytes, a half-warp on 32 banks.
// Every sum runs in a fixed order: reruns are bit-identical.

// The float64 kernel's fixed shape (ops/megakernel.py::PROJ_F64_STAGES and
// PROJ_F64_BLOCKS; tools/f64_kernel_variants.py times other values as
// patched copies)
constexpr int P64_WARPS = 8;
constexpr int P64_THREADS = 32 * P64_WARPS;
constexpr int P64_KC = 2 * NH;          // columns a stage
constexpr int P64_STAGES = 2;           // coef ring
constexpr int P64_BSTAGES = 2;          // basis ring
constexpr int P64_BLOCKS = 2;           // blocks an SM
constexpr int P64_LD = P64_KC + 4;      // coef and basis row stride
// The epilogue's accumulator tile row stride: 8 (mod 16) doubles
#define P64_LDC(bn) ((bn) + 8)

// Shared-memory doubles of a float64 block with S scale rows: the coef
// ring (or the epilogue's accumulator tile where that is larger), the basis
// ring, the time and scale rows. ops/megakernel.py::project_smem mirrors it.
__host__ __device__ constexpr int proj_f64_doubles(int bm, int bn, int S) {
  return (P64_STAGES * bm * P64_LD > bm * P64_LDC(bn)
              ? P64_STAGES * bm * P64_LD
              : bm * P64_LDC(bn)) +
         P64_BSTAGES * bn * P64_LD + (2 + S) * bn;
}

// c += a b: one m16n8k8 float64 product
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// 8 bytes from global to shared memory, asynchronously; zero-filled unless
// `ok`
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Fragment layouts (PTX ISA, m16n8k8 .f64, the .tf32 ones at float64),
// g = lane >> 2, k = lane & 3:
//   A (16 x 8, row): a0 (g, k), a1 (g + 8, k), a2 (g, k + 4), a3 (g + 8, k + 4)
//   B (8 x 8, col):  b0 (k, g), b1 (k + 4, g)
//   C (16 x 8):      c0 (g, 2k), c1 (g, 2k + 1), c2 (g + 8, 2k),
//                    c3 (g + 8, 2k + 1)
// A[m][k] is realization m's coefficient of stage column k (the coef ring,
// [m][k]); B[k][n] is column k's basis value at TOA n (the basis ring,
// [n][k]).
template <int BM, int BN, int WGM>
__global__ void __launch_bounds__(P64_THREADS, P64_BLOCKS)
project_f64_kernel(Operands<double, double> loc, Operands<double, double> full,
                   Stages st, double* __restrict__ res_l,
                   double* __restrict__ res_f, int R, int T, int K, int S,
                   int nloc) {
  constexpr int THREADS = P64_THREADS, WGN = P64_WARPS / WGM;
  constexpr int FM = BM / (16 * WGM), FN = BN / (8 * WGN);
  constexpr int KC = P64_KC, LD = P64_LD, STAGES = P64_STAGES;
  constexpr int NSL = KC / 2;                   // harmonic slots a stage
  constexpr int KSTEPS = KC / 8;
  constexpr int A_ITEMS = BM * KC / THREADS;    // copies a thread a stage
  constexpr int B_ITEMS = BN * NSL / THREADS;   // sincos a thread a stage
  constexpr int AHEAD = STAGES - 1;             // stages copied ahead
  static_assert(FM * 16 * WGM == BM && FN * 8 * WGN == BN, "warp grid");
  static_assert(KC % (2 * NH) == 0 && STAGES >= 2, "stages");
  static_assert(THREADS % KC == 0 && A_ITEMS * THREADS == BM * KC, "copies");
  static_assert(THREADS % NSL == 0 && B_ITEMS * THREADS == BN * NSL, "basis");
  extern __shared__ double dsm[];
  constexpr int A_ROOM = STAGES * BM * LD > BM * P64_LDC(BN)
                             ? STAGES * BM * LD
                             : BM * P64_LDC(BN);
  double* As = dsm;                             // [STAGES][BM][LD], then
                                                // the epilogue's [BM][LDC]
  double* Bs = As + A_ROOM;                     // [2][BN][LD]
  double* rows = Bs + P64_BSTAGES * BN * LD;    // [2 + S][BN]

  const int z = blockIdx.z;
  const bool is_loc = z < nloc;
  const int p = is_loc ? z : z - nloc;
  const int P = is_loc ? loc.P : full.P;
  const double* __restrict__ base = is_loc ? loc.base : full.base;
  const double* __restrict__ coef = is_loc ? loc.coef : full.coef;
  const double* __restrict__ times = is_loc ? loc.times : full.times;
  const double* __restrict__ scales = is_loc ? loc.scales : full.scales;
  double* __restrict__ out = is_loc ? res_l : res_f;
  const int r0 = blockIdx.x * BM, t0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % WGM, wn = warp / WGM;

  // the block's time rows (times 2 pi at float64, as the reference's float64
  // phase) and scale rows; 0 past T
  const double two_pi = 6.28318530717958647692;
  for (int e = tid; e < (2 + S) * BN; e += THREADS) {
    const int row = e / BN, t = t0 + e % BN;
    double v = 0.0;
    if (t < T)
      v = row < 2 ? two_pi * times[((size_t)row * P + p) * T + t]
                  : scales[((size_t)(row - 2) * P + p) * T + t];
    rows[e] = v;
  }

  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

  // Roles, fixed for the whole loop. Copies: the thread's stage column aj
  // (harmonic slot a_slot, cos or sin) for rows tid / KC + (THREADS / KC) i.
  // Basis: slot bu for TOAs tid / NSL + (THREADS / NSL) i.
  const int aj = tid % KC;
  const int a_slot = aj / (2 * NH) * NH + aj % NH;
  const bool a_sin = aj % (2 * NH) >= NH;
  const int bu = tid % NSL;
  const int b_cos = bu / NH * 2 * NH + bu % NH;
  const int b_sin = b_cos + NH;
  const double* __restrict__ coef_p = coef + (size_t)p * K;
  const size_t coef_r = (size_t)P * K;
  const int nq = (K / 2 + NSL - 1) / NSL;       // stages of the contraction

  // the coef column the thread copies in the stage whose first slot is
  // (s, n), or -1 past the last slot
  auto source_col = [&](int s, int n) {
    walk(st, s, n, a_slot);
    return s < st.n ? st.k0[s] + (a_sin ? st.nbin[s] : 0) + n : -1;
  };
  auto copy = [&](double* dst, int col, int i) {
    const int m = tid / KC + THREADS / KC * i, r = r0 + m;
    const bool ok = col >= 0 && r < R;
    cp_async8(dst + m * LD + aj, ok ? coef_p + r * coef_r + col : coef,
              ok);
  };
  // the thread's basis slot in the stage whose first slot is (s, n): its
  // time row, scale row and harmonic number; live = 0 past the last slot
  struct Slot {
    int trow, srow;
    double hn;
    bool live;
  };
  auto basis_slot = [&](int s, int n) {
    walk(st, s, n, bu);
    const bool live = s < st.n;
    return Slot{live ? st.tcol[s] : 0, 2 + (live ? st.scol[s] : 0),
                (double)(n + 1), live};
  };
  auto build = [&](double* dst, const Slot& sl, int i) {
    const int t = tid / NSL + THREADS / NSL * i;
    double bc = 0.0, bs = 0.0;
    if (sl.live && t0 + t < T) {
      const double ph = rows[sl.trow * BN + t] * sl.hn;
      double sn, cs;
      sincos(ph, &sn, &cs);
      const double sv = rows[sl.srow * BN + t];
      bc = cs * sv;
      bs = sn * sv;
    }
    dst[t * LD + b_cos] = bc;
    dst[t * LD + b_sin] = bs;
  };

  // prologue: the copies of the first AHEAD stages, the basis of stage 0
  int sa = 0, na = 0;   // the first slot of the next stage to copy
  int sb = 0, nb = 0;   // ... and to build (block-uniform)
  __syncthreads();      // the rows
#pragma unroll
  for (int q = 0; q < AHEAD; ++q) {
    if (q < nq) {
      const int col = source_col(sa, na);
#pragma unroll
      for (int i = 0; i < A_ITEMS; ++i) copy(As + q * BM * LD, col, i);
    }
    cp_async_commit();
    walk(st, sa, na, NSL);
  }
  if (nq > 0) {
    const Slot sl = basis_slot(sb, nb);
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) build(Bs, sl, i);
  }
  walk(st, sb, nb, NSL);
  cp_async_wait<AHEAD - 1>();
  __syncthreads();

  for (int q = 0; q < nq; ++q) {
    const double* A = As + q % STAGES * BM * LD;
    const double* B = Bs + (q & 1) * BN * LD;
    double* An = As + (q + AHEAD) % STAGES * BM * LD;
    double* Bn = Bs + ((q + 1) & 1) * BN * LD;
    const bool copying = q + AHEAD < nq, building = q + 1 < nq;
    const int col = copying ? source_col(sa, na) : -1;
    const Slot sl = basis_slot(sb, nb);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (copying) {
#pragma unroll
        for (int i = ks; i < A_ITEMS; i += KSTEPS) copy(An, col, i);
      }
      double b[FN][2];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const double* x = B + ((wn * FN + j) * 8 + g) * LD + ks * 8 + k4;
        b[j][0] = x[0];
        b[j][1] = x[4];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const double* x = A + ((wm * FM + i) * 16 + g) * LD + ks * 8 + k4;
        const double a[4] = {x[0], x[8 * LD], x[4], x[8 * LD + 4]};
#pragma unroll
        for (int j = 0; j < FN; ++j) dmma(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    if (building) {
#pragma unroll
      for (int i = 0; i < B_ITEMS; ++i) build(Bn, sl, i);
    }
    cp_async_commit();
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    walk(st, sa, na, NSL);
    walk(st, sb, nb, NSL);
  }

  // epilogue: the accumulators to [BM][LDC] in the coef ring's room
  // (16-byte stores, a quarter-warp on 32 banks), then res = base + acc row
  // by row, consecutive threads on consecutive TOAs
  double* Cs = As;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int m = (wm * FM + i) * 16 + g + 8 * h;
        const int c = (wn * FN + j) * 8 + 2 * k4;
        *reinterpret_cast<double2*>(Cs + m * P64_LDC(BN) + c) =
            make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int m = e / BN, c = e % BN;
    const int r = r0 + m, t = t0 + c;
    if (r < R && t < T) {
      const size_t o = ((size_t)r * P + p) * T + t;
      out[o] = base[o] + Cs[m * P64_LDC(BN) + c];
    }
  }
}

// The float64 kernel's block tile, (BM, BN, WGM) (ops/megakernel.py::
// PROJ_TILE_F64): 128 x 64, 8 warps of 2 x 4 fragments, so that with 32
// columns a stage and a 2-stage coef ring two blocks share an SM
#define FPT_PROJ_F64_TILES(X) X(128, 64, 4)

int dispatch_f64(const void* const* ptrs, int PL, int PF, const Stages& st,
                 double* res_l, double* res_f, int R, int T, int K, int S,
                 int shared, int bm, int bn, int wgm, cudaStream_t stream) {
  const Operands<double, double> loc{static_cast<const double*>(ptrs[0]),
                                     static_cast<const double*>(ptrs[1]),
                                     static_cast<const double*>(ptrs[2]),
                                     static_cast<const double*>(ptrs[3]),
                                     PL};
  const Operands<double, double> full{static_cast<const double*>(ptrs[4]),
                                      static_cast<const double*>(ptrs[5]),
                                      static_cast<const double*>(ptrs[6]),
                                      static_cast<const double*>(ptrs[7]),
                                      PF};
  const int nloc = shared ? 0 : PL;
  const int rows = nloc + PF;
#define FPT_TILE(BM_, BN_, WGM_)                                            \
  if (bm == BM_ && bn == BN_ && wgm == WGM_) {                              \
    const size_t smem =                                                     \
        (size_t)proj_f64_doubles(BM_, BN_, S) * sizeof(double);             \
    auto kernel = project_f64_kernel<BM_, BN_, WGM_>;                       \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);    \
    if (err != cudaSuccess) return (int)err;                                \
    const dim3 grid((unsigned)((R + BM_ - 1) / BM_),                        \
                    (unsigned)((T + BN_ - 1) / BN_), (unsigned)rows);       \
    kernel<<<grid, P64_THREADS, smem, stream>>>(loc, full, st, res_l,      \
                                                res_f, R, T, K, S, nloc);   \
    return 0;                                                               \
  }
  FPT_PROJ_F64_TILES(FPT_TILE)
#undef FPT_TILE
  return (int)cudaErrorInvalidValue;
}

// The shared-memory bytes of the float64 kernel's (bm, bn) tile with S
// scale rows, or -1 if it has none
long long proj_f64_smem(int bm, int bn, int S) {
#define FPT_TILE(BM_, BN_, WGM_)                                            \
  if (bm == BM_ && bn == BN_)                                               \
    return (long long)proj_f64_doubles(BM_, BN_, S) *                       \
           (long long)sizeof(double);
  FPT_PROJ_F64_TILES(FPT_TILE)
#undef FPT_TILE
  return -1;
}

// The stage table of the C entries' arrays, checked against S and K.
inline bool make_stages(Stages& st, int n_stages, const int* nbin,
                        const int* tcol, const int* scol, int S, int K) {
  if (n_stages < 0 || n_stages > MAX_STAGES) return false;
  st.n = n_stages;
  int k0 = 0;
  for (int s = 0; s < MAX_STAGES; ++s) {
    const bool live = s < n_stages;
    st.nbin[s] = live ? nbin[s] : 0;
    st.tcol[s] = live ? tcol[s] : 0;
    st.scol[s] = live ? scol[s] : 0;
    st.k0[s] = k0;
    if (live && (st.nbin[s] <= 0 || st.tcol[s] < 0 || st.tcol[s] > 1 ||
                 st.scol[s] < 0 || st.scol[s] >= S))
      return false;
    k0 += 2 * st.nbin[s];
  }
  return k0 == K;
}

}  // namespace fpt

// C entry. The local set base_l (R, PL, T), coef_l (R, PL, K), times_l
// (2, PL, T), scales_l (S, PL, T) and the full set base_f (R, PF, T),
// coef_f (R, PF, K), times_f (2, PF, T), scales_f (S, PF, T): base and coef
// float32 (store_bf16 = 0) or bfloat16 (store_bf16 = 1), the tables
// float32. Writes the float32 residuals res_l (R, PL, T) and res_f
// (R, PF, T); shared = 1 projects the full set alone (res_l and the local
// operands are not read). Stage s covers coef columns [k0[s], k0[s] +
// 2 nbin[s]) (cos rows then sin rows). (bm, bn, wgm) is one of
// FPT_PROJ_TILES (ops/megakernel.py::project_tiling's). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it has no kernel for.
extern "C" int fpt_project(const void* base_l, const void* coef_l,
                           const void* times_l, const void* scales_l,
                           const void* base_f, const void* coef_f,
                           const void* times_f, const void* scales_f,
                           void* res_l, void* res_f, int R, int PL, int PF,
                           int T, int K, int S, int n_stages, const int* nbin,
                           const int* tcol, const int* scol, int bm, int bn,
                           int wgm, int store_bf16, int shared,
                           void* stream) {
  using namespace fpt;
  if (shared && PL != PF) return (int)cudaErrorInvalidValue;
  Stages st;
  if (!make_stages(st, n_stages, nbin, tcol, scol, S, K))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {base_l, coef_l, times_l, scales_l,
                         base_f, coef_f, times_f, scales_f};
  float* rl = static_cast<float*>(res_l);
  float* rf = static_cast<float*>(res_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      store_bf16
          ? dispatch<__nv_bfloat16>(ptrs, PL, PF, st, rl, rf, R, T, K, S,
                                    shared, bm, bn, wgm, s)
          : dispatch<float>(ptrs, PL, PF, st, rl, rf, R, T, K, S, shared, bm,
                            bn, wgm, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The shared-memory bytes fpt_project requests for a (bm, bn) tile and S
// scale rows (ops/megakernel.py::project_smem must agree).
extern "C" long long fpt_project_smem(int bm, int bn, int S) {
  return (long long)fpt::proj_floats(bm, bn, S) * (long long)sizeof(float);
}

// C entry on a float64 batch: fpt_project's contract with float64 tables
// (times_*, scales_*). store_bf16 = 0: base and coef float64, the float64
// residuals res_l and res_f written by project_f64_kernel at (bm, bn, wgm)
// of FPT_PROJ_F64_TILES. store_bf16 = 1: base and coef bfloat16, the float32
// residuals written by project_kernel at (bm, bn, wgm) of FPT_PROJ_TILES,
// its basis built from the float64 tables (basis_pair). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it has no kernel for.
extern "C" int fpt_project_f64(const void* base_l, const void* coef_l,
                               const void* times_l, const void* scales_l,
                               const void* base_f, const void* coef_f,
                               const void* times_f, const void* scales_f,
                               void* res_l, void* res_f, int R, int PL,
                               int PF, int T, int K, int S, int n_stages,
                               const int* nbin, const int* tcol,
                               const int* scol, int bm, int bn, int wgm,
                               int store_bf16, int shared, void* stream) {
  using namespace fpt;
  if (shared && PL != PF) return (int)cudaErrorInvalidValue;
  Stages st;
  if (!make_stages(st, n_stages, nbin, tcol, scol, S, K))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {base_l, coef_l, times_l, scales_l,
                         base_f, coef_f, times_f, scales_f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      store_bf16
          ? dispatch<__nv_bfloat16, double>(
                ptrs, PL, PF, st, static_cast<float*>(res_l),
                static_cast<float*>(res_f), R, T, K, S, shared, bm, bn, wgm,
                s)
          : dispatch_f64(ptrs, PL, PF, st, static_cast<double*>(res_l),
                         static_cast<double*>(res_f), R, T, K, S, shared, bm,
                         bn, wgm, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The shared-memory bytes fpt_project_f64 requests for a (bm, bn) tile and
// S scale rows (ops/megakernel.py::project_smem must agree).
extern "C" long long fpt_project_f64_smem(int store_bf16, int bm, int bn,
                                          int S) {
  if (store_bf16)
    return (long long)fpt::proj_floats(bm, bn, S, 2) * (long long)sizeof(float);
  return fpt::proj_f64_smem(bm, bn, S);
}
