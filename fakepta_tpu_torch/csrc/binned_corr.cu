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
// (P = 100). At the tensor cores' published rates that is under the memory
// line, so both kernels' floor is the residual read. Neither skips the
// mirrored half of a symmetric block (twice the work the bound counts;
// later work).
//
// Both kernels run one mainloop (mma_mainloop) and differ in their
// epilogues.
//   Tiles. A block's pair tile is BM x BN: BM = PL rounded up to 16, BN = PF
//     rounded up to 8, each at most 128 (wider arrays tile the pair space
//     over grid.y and add the tiles in a fixed-order second pass). The tile
//     is a grid of m16n8 fragments; the block's 8 warps form a WGM x (8/WGM)
//     grid and each warp owns FM x FN fragments of it, the warp tile
//     binned_corr.py::mma_tiling picks so that the busiest warp holds the
//     fewest fragments. A 25-row shard against 100 pulsars runs a 32 x 104
//     tile, not a square 112 x 112 one. Rows past the tile are staged as
//     zeros up to the warp grid's extent, so no warp branches on its
//     fragments (tools/binned_corr_variants.py's 'skip': a warp-uniform
//     branch per fragment costs more than the wasted products).
//   Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in both
//     modes. 'bf16' is one pass on operands rounded to bf16 at staging (a
//     bf16 value is exact in TF32 and its products exact in the fp32
//     accumulator: the TPU kernel's bf16 _corr_block). 'f32' is 3xTF32:
//     hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and per k-step the
//     sum hi.lo + lo.hi + hi.hi from zero, added to the fp32 accumulator
//     with an IEEE add; the dropped lo.lo and the rounding of lo leave
//     ~2^-21 relative per product (binned_corr.py::split_tf32 and
//     binned_correlation_3xtf32 emulate it on the CPU). Chaining the passes
//     in the tensor core's accumulator instead ('chained') comes within a
//     factor 2 of 1e-5 of the curve scale over T = 780, because that
//     accumulation truncates. The reference's
//     'f32' is Precision.HIGHEST, a multi-pass product too. The split is
//     done at staging (hi and lo tiles in shared memory): each residual is
//     split once per block, not once per warp that loads it.
//   Staging: T streams through shared memory in tiles of TT = 32 TOAs,
//     stored transposed ([t][p]), each thread fetching its share of every
//     realization's next tile into registers (16-byte loads, a warp reading
//     64 contiguous bytes of 8 rows) while the current one is multiplied.
//     The row stride LD = rows rounded up to 32, plus 8: LD = 8 (mod 32)
//     puts the fragment loads (lane g + 8k reads [k][g]) on 32 banks; the
//     transposing stores stay on 32 banks because lane k of a row group
//     stores its 4 TOAs rotated by k.
//
// fpt_binned_corr (#1): RB realizations per block in registers, binned
// there.
//   Realizations: a block holds RB realizations' accumulators, each with its
//     own staged tiles. In the epilogue each thread reads w[n, p, q] once
//     per pair it holds and applies it to all RB realizations, then each
//     (realization, slot) reduces in a fixed order (shuffle tree, then the
//     8 warps in order): RB cuts the weight reads through L2 by RB (the old
//     kernel read all NB PL PF weights once per realization; the TPU kernel
//     once per rt). RB per warp tile is what fits 128 registers a thread:
//     two blocks per SM measured faster than one block with more
//     realizations (the phases of two blocks overlap), so RB is 2 for the
//     small warp tiles and 1 for the large (rb_max). The 'f32' kernels of
//     the large warp tiles spill a little at 128 registers (ptxas -v,
//     printed by chip_smoke.py's build phase); the spill-free variant with
//     one block per SM and more realizations per block ('one_block') is
//     slower. The grid is (ceil(R / RB), pair tiles); a ragged last block
//     masks its missing realizations.
//   What holds it back (tools/binned_corr_variants.py): the residual read
//     does not overlap the products (the kernel takes about its time
//     without the read plus the read), because one batch of prefetch
//     registers per tile is all the register file allows; a multi-stage
//     asynchronous copy (cp.async or TMA) is the next step.
//
// fpt_binned_corr_vpu (#2): each slot one block-wide reduction over the
// correlation block in shared memory (the TPU variant's nbins+1
// `jnp.sum(corr * w[n])`), each weight read shared by rb realizations.
//   The block runs the mainloop for its rb realizations one after another
//     (one realization's accumulators in registers) and each warp stores its
//     fragments into that realization's [nrows][LDC] correlation block in
//     shared memory; the last block takes the staging tiles' room, free
//     once the mainloop has ended. LDC is BN, or BN + 8 where BN = 0 or 16
//     (mod 32): LDC = 8 or 24 (mod 32) keeps the 8-byte fragment stores on
//     32 banks, and consecutive threads read consecutive elements of the
//     [nrows][LDC] block.
//   Then each slot is one fixed-order reduction over the whole block:
//     thread k takes the elements k, k + 256, ... (consecutive threads on
//     consecutive q, so the w[n, p, q] reads coalesce; columns past the tile
//     are masked), reads each weight once for all rb blocks, and a fixed
//     shuffle tree folds each warp; thread (r, n) adds the 8 warp sums in
//     warp order. A pass carries VPU_SLOTS slots, so that many weight loads
//     are in flight and each correlation element is read once per pass.
//   rb is binned_corr.py::vpu_tiling's choice alone: the largest power of
//     two up to VPU_RB whose correlation blocks, staging tiles and warp
//     sums fit the shared memory of VPU_BLOCKS blocks per SM (a power of
//     two so that a power-of-two ensemble fills whole waves of blocks);
//     the C entry takes it packed beside the warp grid. Shared memory
//     bounds it, not registers. Two blocks per SM measured faster than one
//     holding more realizations (tools/binned_corr_variants.py
//     --kernel vpu).
//
// fpt_binned_corr_f64 (#1 on a float64 batch, the same TPU kernel at float64
// operands): in the 'f32' mode, corr_f64_kernel (its design is beside it)
// on the FP64 tensor cores, with the pair sums rounded to float32 and binned
// at float64 (the fused path; float32 output) or kept at float64 (the
// megakernel's pass 2; float64 output); in the 'bf16' mode, #1's bf16 kernel
// with each float64 residual rounded to bf16 through float32 at staging (as
// the TPU kernel's astype rounds it) and the float32 pair sums binned at float64 against the float64 weights. What
// bounds the DMMA kernel at the flagship (R = 1024, P = 100, T = 780): the
// residual read, R P T 8 = 639 MB, 0.19 ms at 3.35 TB/s, against the
// P (P + 1) / 2 distinct pairs' 8.0 GFLOP, 0.12 ms at the FP64 tensor
// cores' 67 TFLOP/s (the whole block, which the kernel computes: 16 GFLOP,
// 0.24 ms). It is a first, simple design: one realization per block, so
// each block reads its tile's float64 weights once per realization through
// L2, and one block of 16 warps per SM.
//
// No float atomic anywhere: reruns are bit-identical.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "corr_common.cuh"

namespace fpt {

constexpr int MMA_TILE = 128;   // a pair tile is at most 128 x 128 pulsars
constexpr int WARPS = 8;        // warps per block, two blocks per SM
constexpr int THREADS = 32 * WARPS;

// Realizations per block of #1 for a warp tile of FM x FN fragments, with
// one operand tile (the single-device path) or two (DUAL): the most whose
// accumulators (RB FM FN 4 registers) and prefetch registers fit the 128
// registers a thread has at two blocks per SM (ptxas -v, printed by
// chip_smoke.py's build phase). The launch takes it from here alone.
__host__ __device__ constexpr int rb_max(int fm, int fn, bool dual) {
  return fm == 1 && fn == 4 ? 2 : fm == 1 && fn <= 2 && !dual ? 2 : 1;
}

// Rows a realization stages per T tile: the warp grid's whole extent,
// 16 FM WGM row pulsars and 8 FN (8 / WGM) column pulsars (zeros past the
// tile), so every warp multiplies all its fragments with no branch; without
// DUAL one tile of max(the two) rows serves both operands. A warp grid
// whose extent passes 128 on either side is never used.
__host__ __device__ constexpr int staged_rows(int fm, int fn, int wgm,
                                              bool dual, bool col) {
  return col ? (dual ? 8 * fn * (WARPS / wgm) : 0)
         : dual ? 16 * fm * wgm
         : 16 * fm * wgm > 8 * fn * (WARPS / wgm) ? 16 * fm * wgm
                                                  : 8 * fn * (WARPS / wgm);
}

__host__ __device__ constexpr bool grid_fits(int fm, int fn, int wgm) {
  return 16 * fm * wgm <= MMA_TILE && 8 * fn * (WARPS / wgm) <= MMA_TILE;
}

__host__ __device__ constexpr int max_staged_rows(int fm, int fn, bool dual) {
  int most = 0;
  for (int wgm = 1; wgm <= WARPS; wgm *= 2) {
    const int rows = staged_rows(fm, fn, wgm, dual, false) +
                     staged_rows(fm, fn, wgm, dual, true);
    if (grid_fits(fm, fn, wgm) && rows > most) most = rows;
  }
  return most;
}

// shared-memory row stride for a tile of `rows` pulsars: = 8 (mod 32)
__host__ __device__ constexpr int mma_ld(int rows) {
  return (rows + 31) / 32 * 32 + 8;
}

// floats of one realization's staging tiles
__host__ __device__ constexpr int staging_floats(int fm, int fn, int wgm,
                                                 bool f32, bool dual) {
  return (f32 ? 2 : 1) * TT *
         (mma_ld(staged_rows(fm, fn, wgm, dual, false)) +
          (dual ? mma_ld(staged_rows(fm, fn, wgm, dual, true)) : 0));
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

// A residual as the mainloop stages it: a float32 one as it is; a float64
// one (the bf16 mode of a float64 batch, fpt_binned_corr_f64) rounded to
// float32, then to bf16, as the TPU kernel's astype(bfloat16) of a float64
// row rounds (through float32), then held in float
__device__ __forceinline__ float stage_in(float x) { return x; }
__device__ __forceinline__ float stage_in(double x) {
  return __bfloat162float(__float2bfloat16_rn(__double2float_rn(x)));
}

// four consecutive residuals from a 16-byte aligned address (float32) or a
// 32-byte aligned one (float64: two 16-byte loads), as stage_in gives them
__device__ __forceinline__ float4 load4(const float* x) {
  return __ldg(reinterpret_cast<const float4*>(x));
}
__device__ __forceinline__ float4 load4(const double* x) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(x));
  const double2 b = __ldg(reinterpret_cast<const double2*>(x) + 1);
  return make_float4(stage_in(a.x), stage_in(a.y), stage_in(b.x),
                     stage_in(b.y));
}

// c + a b at the binning's type, rounded once
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// ---------------------------------------------------------------------------
// The mainloop of both kernels

// One block's accumulators: RB realizations' FM x FN m16n8 fragments.
template <int RB, int FM, int FN>
struct MmaAcc {
  float v[RB][FM][FN][4];
};

// Returns acc, acc.v[r] = this warp's FM x FN fragments of realization
// r0 + r's block of the pair tile blockIdx.y, summed over all of T, for
// r < nr = min(RB, R - r0) and r0 = rb blockIdx.x + r1 (#1: rb = RB,
// r1 = 0, its block's RB realizations, nr < RB in a ragged last block;
// #2: RB = 1, its block's r1-th). The branches on r < nr are
// block-uniform. smem holds the RB realizations' staging tiles; the loop
// ends on a barrier, so they are free when it returns.
// It derives the tile's indices itself, in the order its callers' epilogues
// derive them again (the compiler merges the two), and returns the
// accumulators by value, so they stay a local array of the loop's own
// function: a reference parameter leaves them in memory while the
// compiler simplifies the loop, which moves #1's 'f32' register
// allocation and spills (ptxas -v).
//
// Fragment layouts (PTX ISA, m16n8k8 .tf32), g = lane >> 2, k = lane & 3:
//   A (16 x 8, row): a0 (g, k), a1 (g + 8, k), a2 (g, k + 4), a3 (g + 8, k + 4)
//   B (8 x 8, col):  b0 (k, g), b1 (k + 4, g)
//   C (16 x 8):      c0 (g, 2k), c1 (g, 2k + 1), c2 (g + 8, 2k),
//                    c3 (g + 8, 2k + 1)
// A[m][t] is row pulsar m's residual at TOA t, B[t][n] column pulsar n's;
// both sit in shared memory as [t][pulsar], so a0 is As[k][g] and b0 Bs[k][g].
template <int FM, int FN, int RB, bool F32, bool DUAL, typename TI = float>
__device__ __forceinline__ MmaAcc<RB, FM, FN> mma_mainloop(
    const TI* __restrict__ res_l, const TI* __restrict__ res_f, int R,
    int PL, int PF, int T, int wgm, int ntf, int rb, int r1, float* smem) {
  // per realization: the row operand's tile, then the column operand's
  // (DUAL), each [TT][ld] and in the 'f32' mode a hi tile then a lo tile
  constexpr int NS = F32 ? 2 : 1;
  constexpr int ROWS_PER_K = 8 * WARPS / 2;     // staged rows per fetch step
  constexpr int PER = (max_staged_rows(FM, FN, DUAL) + ROWS_PER_K - 1) /
                      ROWS_PER_K;
  const int arows = staged_rows(FM, FN, wgm, DUAL, false);
  const int staged = arows + staged_rows(FM, FN, wgm, DUAL, true);
  const int lda = mma_ld(arows);
  const int ldb = DUAL ? mma_ld(staged - arows) : lda;
  const int boff = DUAL ? NS * TT * lda : 0;   // column operand's offset
  const int stride = NS * TT * (lda + (DUAL ? ldb : 0));

  const int r0 = blockIdx.x * rb + r1, nr = min(RB, R - r0);
  const int tile = blockIdx.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * MMA_TILE, col0 = tj * MMA_TILE;
  const int nrows = min(MMA_TILE, PL - row0), ncols = min(MMA_TILE, PF - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % wgm, wn = warp / wgm;

  MmaAcc<RB, FM, FN> out;
  auto& acc = out.v;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][i][j][c] = 0.f;

  // Staging. Thread (warp, lane) fetches TOAs 4 tg .. 4 tg + 3, tg =
  // 4 (warp & 1) + (lane & 3), of staged rows rho = 32 k + 8 (warp >> 1) +
  // (lane >> 2), k < PER, as one 16-byte load where T allows it (a warp
  // reads 64 contiguous bytes of 8 rows). Rows below arows are res_l's,
  // the rest res_f's (arows is a multiple of 16: the split is warp-uniform).
  // Its e-th store writes TOA 4 tg + ((e + lane) & 3): the four lanes of a
  // row group then write four TOA rows, 8 banks apart, so the transposing
  // stores stay on 32 banks.
  const bool vec = T % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(res_l) |
                     reinterpret_cast<uintptr_t>(res_f)) & 15) == 0;
  const int tg = 4 * (warp & 1) + k4;
  float reg[RB][PER][4];
  auto fetch = [&](int t0) {
    const int t = t0 + 4 * tg;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= nr) continue;
      const size_t rr = (size_t)(r0 + r);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int rho = ROWS_PER_K * k + 8 * (warp >> 1) + g;
        const TI* x = nullptr;
        if (rho < arows) {
          if (rho < nrows) x = res_l + (rr * PL + row0 + rho) * T + t;
        } else if (DUAL && rho < staged && rho - arows < ncols) {
          x = res_f + (rr * PF + col0 + rho - arows) * T + t;
        }
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (x != nullptr) {
          if (vec) {
            if (t < T) v = load4(x);
          } else {
            v.x = t < T ? stage_in(x[0]) : 0.f;
            v.y = t + 1 < T ? stage_in(x[1]) : 0.f;
            v.z = t + 2 < T ? stage_in(x[2]) : 0.f;
            v.w = t + 3 < T ? stage_in(x[3]) : 0.f;
          }
        }
        reg[r][k][0] = v.x;
        reg[r][k][1] = v.y;
        reg[r][k][2] = v.z;
        reg[r][k][3] = v.w;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int rho = ROWS_PER_K * k + 8 * (warp >> 1) + g;
        float* dst;
        int ld;
        if (rho < arows) {
          dst = smem + r * stride + rho;
          ld = lda;
        } else if (DUAL && rho < staged) {
          dst = smem + r * stride + boff + rho - arows;
          ld = ldb;
        } else {
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sel = (e + k4) & 3;
          const float v = sel == 0   ? reg[r][k][0]
                          : sel == 1 ? reg[r][k][1]
                          : sel == 2 ? reg[r][k][2]
                                     : reg[r][k][3];
          float* d = dst + (4 * tg + sel) * ld;
          if (F32) {
            const uint32_t hi = to_tf32(v);
            d[0] = __uint_as_float(hi);
            d[TT * ld] = __uint_as_float(to_tf32(v - __uint_as_float(hi)));
          } else {
            d[0] = round_bf16(v);
          }
        }
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < T; t0 += TT) {
    stage();
    __syncthreads();
    if (t0 + TT < T) fetch(t0 + TT);
#pragma unroll
    for (int ks = 0; ks < TT; ks += 8) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= nr) continue;
        const float* As =
            smem + r * stride + (ks + k4) * lda + wm * FM * 16 + g;
        const float* Bs =
            smem + r * stride + boff + (ks + k4) * ldb + wn * FN * 8 + g;
        uint32_t ah[FM][4], al[FM][4];
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = (c & 2 ? 4 * lda : 0) + 16 * i + (c & 1) * 8;
            ah[i][c] = __float_as_uint(As[col]);
            al[i][c] = F32 ? __float_as_uint(As[TT * lda + col]) : 0u;
          }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const float* b = Bs + 8 * j;
          const uint32_t h0 = __float_as_uint(b[0]);
          const uint32_t h1 = __float_as_uint(b[4 * ldb]);
          const uint32_t l0 = F32 ? __float_as_uint(b[TT * ldb]) : 0u;
          const uint32_t l1 = F32 ? __float_as_uint(b[TT * ldb + 4 * ldb]) : 0u;
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            if (F32) {
              // the k-step's three passes start from zero and join the
              // sum with an IEEE add: the tensor core's own accumulation
              // truncates, which over ~300 chained passes costs ~1e-5 of
              // the curve scale
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(d, ah[i], l0, l1);
              mma_tf32(d, al[i], h0, h1);
              mma_tf32(d, ah[i], h0, h1);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][i][j][c] += d[c];
            } else {
              mma_tf32(acc[r][i][j], ah[i], h0, h1);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  return out;
}

// ---------------------------------------------------------------------------
// #1: RB realizations per block, binned in registers (fpt_binned_corr)

// TI: the residuals' type; TW: the weights', the binning's and the
// partials'; TO: the output's. float32 throughout, or, for the bf16 mode of a
// float64 batch (fpt_binned_corr_f64), float64 residuals staged as bf16, the
// float32 pair sums binned against float64 weights at float64 and the sum
// rounded once to a float32 output.
template <int FM, int FN, int RB, bool F32, bool DUAL, typename TI = float,
          typename TW = float, typename TO = float>
__global__ void __launch_bounds__(THREADS, 2)
mma_corr_kernel(const TI* __restrict__ res_l, const TI* __restrict__ res_f,
                const TW* __restrict__ w, TO* __restrict__ out,
                TW* __restrict__ partial, int R, int PL, int PF, int T, int NB,
                int wgm, int ntf) {
  extern __shared__ float smem[];
  const MmaAcc<RB, FM, FN> mma = mma_mainloop<FM, FN, RB, F32, DUAL, TI>(
      res_l, res_f, R, PL, PF, T, wgm, ntf, RB, 0, smem);
  const auto& acc = mma.v;
  const int r0 = blockIdx.x * RB, nr = min(RB, R - r0);
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * MMA_TILE, col0 = tj * MMA_TILE;
  const int nrows = min(MMA_TILE, PL - row0), ncols = min(MMA_TILE, PF - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % wgm, wn = warp / wgm;

  // Epilogue: every weight this thread's pairs need, read once and applied
  // to all RB realizations; each (realization, slot) reduces over the lanes
  // (fixed shuffle tree) and then over the warps in order. A pair past the
  // tile's edge has a zero correlation and reads the edge's weight (no
  // branch). The staging tiles are free now and hold the [RB][NB][WARPS]
  // warp sums.
  TW* red = reinterpret_cast<TW*>(smem);
  for (int n = 0; n < NB; ++n) {
    const TW* wn_ = w + (size_t)n * PL * PF + (size_t)row0 * PF + col0;
    TW wv[FM][2][FN][2];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int p = min((wm * FM + i) * 16 + g + 8 * h, nrows - 1);
            const int q = min((wn * FN + j) * 8 + 2 * k4 + c, ncols - 1);
            wv[i][h][j][c] = __ldg(wn_ + (size_t)p * PF + q);
          }
    TW s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      s[r] = 0;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              s[r] = fma_t((TW)acc[r][i][j][2 * h + c], wv[i][h][j][c], s[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[r] += __shfl_down_sync(0xffffffffu, s[r], off);
      if (lane == 0) red[(r * NB + n) * WARPS + warp] = s[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * NB; idx += THREADS) {
    const int r = idx / NB, n = idx - r * NB;
    TW s = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[idx * WARPS + k];
    if (ntiles == 1)
      out[(size_t)(r0 + r) * NB + n] = (TO)s;
    else
      partial[((size_t)(r0 + r) * ntiles + tile) * NB + n] = s;
  }
}

template <int FM, int FN, bool F32, bool DUAL, typename TI, typename TW,
          typename TO>
int launch_mma_kernel(const TI* res_l, const TI* res_f, const TW* w, TO* out,
                      TW* partial, int R, int PL, int PF, int T, int NB,
                      int wgm, int ntl, int ntf, cudaStream_t stream) {
  constexpr int RB = rb_max(FM, FN, DUAL);
  const size_t staging =
      (size_t)RB * staging_floats(FM, FN, wgm, F32, DUAL) * sizeof(float);
  const size_t sums = (size_t)RB * NB * WARPS * sizeof(TW);
  const size_t smem = staging > sums ? staging : sums;
  auto kernel = mma_corr_kernel<FM, FN, RB, F32, DUAL, TI, TW, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + RB - 1) / RB), (unsigned)(ntl * ntf));
  kernel<<<grid, THREADS, smem, stream>>>(res_l, res_f, w, out, partial, R,
                                          PL, PF, T, NB, wgm, ntf);
  if (ntl * ntf > 1)
    launch_reduce<TW, TO>(partial, out, R, ntl * ntf, NB, stream);
  return 0;
}

// ---------------------------------------------------------------------------
// #2: correlation blocks in shared memory, one block-wide reduction per slot
// (fpt_binned_corr_vpu)

constexpr int VPU_BLOCKS = 2;   // blocks per SM (binned_corr.py::VPU_BLOCKS)
constexpr int VPU_RB = 4;       // most realizations a block bins together
constexpr int VPU_SLOTS = 4;    // weight slots per reduction pass

// the correlation block's row stride for a pair tile bn pulsars wide:
// = 8 or 24 (mod 32)
__host__ __device__ constexpr int vpu_ldc(int bn) {
  return bn % 32 == 0 || bn % 32 == 16 ? bn + 8 : bn;
}

// A #2 block's shared memory, in floats from its start: rb - 1 correlation
// blocks of cslot floats, the staging tiles (whose room the last block
// takes once the mainloop has ended), then the [rb][NB][WARPS] warp sums
// at red. binned_corr.py::vpu_smem mirrors it.
struct VpuLayout {
  int ldc, cslot, red, floats;
};

__host__ __device__ constexpr VpuLayout vpu_layout(int PL, int PF, int NB,
                                                   int fm, int fn, int wgm,
                                                   int rb, bool f32,
                                                   bool dual) {
  const int ldc = vpu_ldc(PF < MMA_TILE ? (PF + 7) / 8 * 8 : MMA_TILE);
  const int cslot = (PL < MMA_TILE ? PL : MMA_TILE) * ldc;
  const int staging = staging_floats(fm, fn, wgm, f32, dual);
  const int red = (rb - 1) * cslot + (staging > cslot ? staging : cslot);
  return {ldc, cslot, red, red + rb * NB * WARPS};
}

template <int FM, int FN, bool F32, bool DUAL>
__global__ void __launch_bounds__(THREADS, VPU_BLOCKS)
vpu_corr_kernel(const float* __restrict__ res_l,
                const float* __restrict__ res_f, const float* __restrict__ w,
                float* __restrict__ out, float* __restrict__ partial, int R,
                int PL, int PF, int T, int NB, int wgm, int ntf, int rb,
                VpuLayout lay) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rb, nr = min(rb, R - r0);
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * MMA_TILE, col0 = tj * MMA_TILE;
  const int nrows = min(MMA_TILE, PL - row0), ncols = min(MMA_TILE, PF - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % wgm, wn = warp / wgm;
  const int ldc = lay.ldc, cslot = lay.cslot;

  // realization r's correlation block into slot r: rows past nrows are
  // never read, and a column pair starting before ncols lies inside LDC
  for (int r = 0; r < nr; ++r) {
    const MmaAcc<1, FM, FN> mma = mma_mainloop<FM, FN, 1, F32, DUAL>(
        res_l, res_f, R, PL, PF, T, wgm, ntf, rb, r, smem + (rb - 1) * cslot);
    const auto& acc = mma.v;
    float* C = smem + r * cslot;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm * FM + i) * 16 + g + 8 * h;
        if (p >= nrows) continue;
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int q = (wn * FN + j) * 8 + 2 * k4;
          if (q < ncols)
            *reinterpret_cast<float2*>(C + p * ldc + q) =
                make_float2(acc[0][i][j][2 * h], acc[0][i][j][2 * h + 1]);
        }
      }
  }
  __syncthreads();

  // Slots n0 .. n0 + VPU_SLOTS - 1 per pass: thread tid sums the elements
  // e = tid + 256 k of the [nrows][LDC] blocks, (p, q) = (e / LDC, e % LDC)
  // stepped without a division; wo is (p, q)'s offset in a weight tile.
  float* red = smem + lay.red;
  const int nel = nrows * ldc;
  const int dq = THREADS % ldc, dwo = THREADS / ldc * PF + dq;
  const float* wt = w + (size_t)row0 * PF + col0;
  for (int n0 = 0; n0 < NB; n0 += VPU_SLOTS) {
    float s[VPU_SLOTS][VPU_RB];
#pragma unroll
    for (int k = 0; k < VPU_SLOTS; ++k)
#pragma unroll
      for (int r = 0; r < VPU_RB; ++r) s[k][r] = 0.f;
    int q = tid % ldc, wo = tid / ldc * PF + q;
#pragma unroll 2
    for (int e = tid; e < nel; e += THREADS) {
      if (q < ncols) {
        float wv[VPU_SLOTS];
#pragma unroll
        for (int k = 0; k < VPU_SLOTS; ++k)
          wv[k] = n0 + k < NB ? __ldg(wt + (size_t)(n0 + k) * PL * PF + wo)
                              : 0.f;
#pragma unroll
        for (int r = 0; r < VPU_RB; ++r) {
          if (r >= nr) continue;
          const float c = smem[r * cslot + e];
#pragma unroll
          for (int k = 0; k < VPU_SLOTS; ++k)
            s[k][r] = fmaf(c, wv[k], s[k][r]);
        }
      }
      q += dq;
      wo += dwo;
      if (q >= ldc) {
        q -= ldc;
        wo += PF - ldc;
      }
    }
#pragma unroll
    for (int k = 0; k < VPU_SLOTS; ++k) {
      if (n0 + k >= NB) continue;
#pragma unroll
      for (int r = 0; r < VPU_RB; ++r) {
        if (r >= nr) continue;
        float v = s[k][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[(r * NB + n0 + k) * WARPS + warp] = v;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nr * NB; idx += THREADS) {
    const int r = idx / NB, n = idx - r * NB;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[idx * WARPS + k];
    if (ntiles == 1)
      out[(size_t)(r0 + r) * NB + n] = s;
    else
      partial[((size_t)(r0 + r) * ntiles + tile) * NB + n] = s;
  }
}

template <int FM, int FN, bool F32, bool DUAL>
int launch_vpu_kernel(const float* res_l, const float* res_f, const float* w,
                      float* out, float* partial, int R, int PL, int PF,
                      int T, int NB, int wgm, int rb, int ntl, int ntf,
                      cudaStream_t stream) {
  const VpuLayout lay = vpu_layout(PL, PF, NB, FM, FN, wgm, rb, F32, DUAL);
  const size_t smem = (size_t)lay.floats * sizeof(float);
  auto kernel = vpu_corr_kernel<FM, FN, F32, DUAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + rb - 1) / rb), (unsigned)(ntl * ntf));
  kernel<<<grid, THREADS, smem, stream>>>(res_l, res_f, w, out, partial, R,
                                          PL, PF, T, NB, wgm, ntf, rb, lay);
  if (ntl * ntf > 1)
    launch_reduce<float, float>(partial, out, R, ntl * ntf, NB, stream);
  return 0;
}

// Both entries' arguments, decoded and checked: the warp grid (wgm, fm, fn)
// from the packed tiling, the pair tiles, the operand sets, the mode.
struct Launch {
  const void *res_l, *res_f, *w;
  void *out, *partial;
  int R, PL, PF, T, NB, wgm, fm, fn, rb, ntl, ntf;
  bool f32, dual;
  cudaStream_t stream;
};

inline bool decode(Launch& a, const void* res_l, const void* res_f,
                   const void* w, void* out, void* partial, int R, int PL,
                   int PF, int T, int NB, int tiling, int bf16, int shared,
                   void* stream) {
  a.res_l = res_l, a.res_f = res_f, a.w = w;
  a.out = out, a.partial = partial;
  a.R = R, a.PL = PL, a.PF = PF, a.T = T, a.NB = NB;
  a.wgm = tiling & 15, a.fm = (tiling >> 4) & 15, a.fn = (tiling >> 8) & 15;
  a.rb = (tiling >> 12) & 15;
  const int bm = std::min(MMA_TILE, (PL + 15) / 16 * 16);
  const int bn = std::min(MMA_TILE, (PF + 7) / 8 * 8);
  a.ntl = (PL + bm - 1) / bm, a.ntf = (PF + bn - 1) / bn;
  // one pair tile of one shared operand: correlate the tile with itself
  a.dual = !(shared && a.ntl * a.ntf == 1);
  a.f32 = !bf16;
  a.stream = static_cast<cudaStream_t>(stream);
  return a.wgm >= 1 && a.wgm <= WARPS && (a.wgm & (a.wgm - 1)) == 0 &&
         grid_fits(a.fm, a.fn, a.wgm) && 16 * a.fm * a.wgm >= bm &&
         8 * a.fn * (WARPS / a.wgm) >= bn;
}

// #1 on the decoded arguments at (TI, TW, TO) (mma_corr_kernel); the float64
// residuals take the bf16 mode only, so no 'f32' kernel is built for them
template <int FM, int FN, typename TI = float, typename TW = float,
          typename TO = float>
int launch_mma(const Launch& a) {
#define FPT_LAUNCH(F, D)                                                   \
  return launch_mma_kernel<FM, FN, F, D, TI, TW, TO>(                     \
      static_cast<const TI*>(a.res_l), static_cast<const TI*>(a.res_f),   \
      static_cast<const TW*>(a.w), static_cast<TO*>(a.out),               \
      static_cast<TW*>(a.partial), a.R, a.PL, a.PF, a.T, a.NB, a.wgm,     \
      a.ntl, a.ntf, a.stream)
  if constexpr (std::is_same<TI, float>::value) {
    if (a.f32) {
      if (a.dual) FPT_LAUNCH(true, true);
      FPT_LAUNCH(true, false);
    }
  }
  if (a.dual) FPT_LAUNCH(false, true);
  FPT_LAUNCH(false, false);
#undef FPT_LAUNCH
}

template <int FM, int FN>
int launch_vpu(const Launch& a) {
#define FPT_LAUNCH(F, D)                                                   \
  return launch_vpu_kernel<FM, FN, F, D>(                                 \
      static_cast<const float*>(a.res_l), static_cast<const float*>(a.res_f), \
      static_cast<const float*>(a.w), static_cast<float*>(a.out),         \
      static_cast<float*>(a.partial), a.R, a.PL, a.PF, a.T, a.NB, a.wgm,  \
      a.rb, a.ntl, a.ntf, a.stream)
  if (a.f32) {
    if (a.dual) FPT_LAUNCH(true, true);
    FPT_LAUNCH(true, false);
  }
  if (a.dual) FPT_LAUNCH(false, true);
  FPT_LAUNCH(false, false);
#undef FPT_LAUNCH
}

// ---------------------------------------------------------------------------
// #1 at float64 on the FP64 tensor cores (fpt_binned_corr_f64, bf16 = 0)
//
// One realization per block on binned_corr.py::mma_tiling's pair tiles (the
// float32 kernel's; a wider array adds the tiles in the fixed-order second
// pass), 16 warps in a 4 x 4 grid, each owning 2 x 4 m16n8 fragments of
// the at most 128 x 128 tile (fragments wholly past the tile's edge
// skipped, warp-uniform). Products: mma.sync.aligned.m16n8k8 .f64 (DMMA),
// float64 accumulation: the m8n8k4 shape runs at half the FP64 tensor
// cores' rate on an H100 (33.3 against 66.6 TFLOP/s,
// tools/dmma_shapes.py). T streams through shared memory in tiles of D_TT
// TOAs, both operands [pulsar][t] with row stride D_LDT = 4 (mod 16)
// doubles, so the fragment loads (lane g + 8 i reads [g][k]) stay on 32
// banks; cp.async
// copies the next tile while the current one is multiplied (two stages). The
// epilogue puts the pair sums in shared memory and bins them against their
// float64 weights at float64, every weight read once per block and
// coalesced (binning from the registers, each thread reading its pairs'
// scattered weights slot by slot, took 1.03 of the kernel's 1.32 ms at the
// flagship, tools/f64_kernel_variants.py): in the fused flavour (OUT_F32)
// the pair sums are first rounded to float32 and each slot's sum is rounded
// once to a float32 output (the TPU kernel's float32 correlation scratch
// and output at float64 operands); in the megakernel's (pass 2 of
// chunk_stats at float64) every value stays float64.

constexpr int D_WARPS = 16;                     // one block of 16 warps an SM
constexpr int D_THREADS = 32 * D_WARPS;
constexpr int D_WGM = 4, D_WGN = 4;             // warp grid over the tile
constexpr int D_FM = MMA_TILE / (16 * D_WGM);   // m16 row fragments a warp
constexpr int D_FN = MMA_TILE / (8 * D_WGN);    // n8 column fragments
constexpr int D_TT = 16;                        // TOAs per staged tile
constexpr int D_LDT = D_TT + 4;                 // = 4 (mod 16) doubles
constexpr int D_STAGE = 2 * MMA_TILE * D_LDT;   // doubles per stage
constexpr int D_LDC = MMA_TILE + 4;             // the epilogue tile's stride
constexpr int D_SLOTS = 4;                      // weight slots a pass

// the epilogue's warp sums, in doubles from the start of shared memory:
// past the [MMA_TILE][D_LDC] pair-sum tile (float32 or float64)
__host__ __device__ constexpr int d_red_offset(bool f32) {
  return MMA_TILE * D_LDC / (f32 ? 2 : 1);
}

// shared-memory bytes of corr_f64_kernel: the two staging stages, or the
// epilogue's tile and its NB x D_WARPS warp sums where that is larger
__host__ __device__ constexpr long d_smem(bool f32, int NB) {
  return 8L * (2 * D_STAGE > d_red_offset(f32) + NB * D_WARPS
                   ? 2 * D_STAGE
                   : d_red_offset(f32) + NB * D_WARPS);
}

// c += a b: one m16n8k8 float64 product; its fragments are the TF32
// m16n8k8 ones (mma_mainloop's comment) at float64
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `valid` (0, 8 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool OUT_F32>
__global__ void __launch_bounds__(D_THREADS, 1)
corr_f64_kernel(const double* __restrict__ res_l,
                 const double* __restrict__ res_f,
                 const double* __restrict__ w, void* __restrict__ out,
                 double* __restrict__ partial, int R, int PL, int PF, int T,
                 int NB, int ntf) {
  extern __shared__ double dsm[];
  const int r = blockIdx.x;
  const int tile = blockIdx.y, ntiles = gridDim.y;
  const int ti = tile / ntf, tj = tile % ntf;
  const int row0 = ti * MMA_TILE, col0 = tj * MMA_TILE;
  const int nrows = min(MMA_TILE, PL - row0), ncols = min(MMA_TILE, PF - col0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, k4 = lane & 3;
  const int wm = warp % D_WGM, wn = warp / D_WGM;
  // this warp's fragments that hold a row (column) of the tile
  const int live_m = max(0, min(D_FM, (nrows - 16 * D_FM * wm + 15) / 16));
  const int live_n = max(0, min(D_FN, (ncols - 8 * D_FN * wn + 7) / 8));

  double acc[D_FM][D_FN][4];
#pragma unroll
  for (int i = 0; i < D_FM; ++i)
#pragma unroll
    for (int j = 0; j < D_FN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

  // A stage holds the row operand's 128 rows, then the column operand's
  // 128, [row][t]; rows past the tile and TOAs past T are zeros. Each thread
  // copies 16-byte pairs of TOAs (a row's D_TT TOAs are 8 consecutive
  // threads' 128 contiguous bytes); without 16-byte alignment (T odd) it
  // loads and stores them itself.
  const bool vec = T % 2 == 0 &&
                   ((reinterpret_cast<uintptr_t>(res_l) |
                     reinterpret_cast<uintptr_t>(res_f)) & 15) == 0;
  const size_t rl = (size_t)r * PL + row0, rf = (size_t)r * PF + col0;
  auto load = [&](int t0, double* st) {
    constexpr int PAIRS = D_TT / 2;
    for (int c = tid; c < 2 * MMA_TILE * PAIRS; c += D_THREADS) {
      const int row = c / PAIRS, t = t0 + 2 * (c % PAIRS);
      const bool col = row >= MMA_TILE;
      const int rho = col ? row - MMA_TILE : row;
      const bool ok = rho < (col ? ncols : nrows) && t < T;
      const double* src =
          ok ? (col ? res_f + (rf + rho) * T : res_l + (rl + rho) * T) + t
             : res_l;
      double* dst = st + row * D_LDT + 2 * (c % PAIRS);
      if (vec) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        dst[0] = ok ? __ldg(src) : 0.0;
        dst[1] = ok && t + 1 < T ? __ldg(src + 1) : 0.0;
      }
    }
    cp_async_commit();
  };

  const int nt = (T + D_TT - 1) / D_TT;
  if (nt > 0) load(0, dsm);
  for (int k = 0; k < nt; ++k) {
    const double* cur = dsm + (k & 1) * D_STAGE;
    if (k + 1 < nt) {
      load((k + 1) * D_TT, dsm + ((k + 1) & 1) * D_STAGE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < D_TT; ks += 8) {
      // A (16 x 8): a0 (g, k), a1 (g + 8, k), a2 (g, k + 4), a3 (g + 8,
      // k + 4); B (8 x 8): b0 (k, g), b1 (k + 4, g)
      double a[D_FM][4], b[D_FN][2];
#pragma unroll
      for (int i = 0; i < D_FM; ++i) {
        const double* x = cur + ((wm * D_FM + i) * 16 + g) * D_LDT + ks + k4;
        a[i][0] = x[0];
        a[i][1] = x[8 * D_LDT];
        a[i][2] = x[4];
        a[i][3] = x[8 * D_LDT + 4];
      }
#pragma unroll
      for (int j = 0; j < D_FN; ++j) {
        const double* x =
            cur + (MMA_TILE + (wn * D_FN + j) * 8 + g) * D_LDT + ks + k4;
        b[j][0] = x[0];
        b[j][1] = x[4];
      }
#pragma unroll
      for (int i = 0; i < D_FM; ++i)
#pragma unroll
        for (int j = 0; j < D_FN; ++j)
          if (i < live_m && j < live_n)
            dmma(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();
  }

  // Epilogue. The pair sums (rounded to float32 in the fused flavour) go to
  // a [128][D_LDC] tile in shared memory (the staging room and past it);
  // then each slot pass of D_SLOTS slots reads every weight of the tile
  // once, coalesced (warp w takes rows w, w + 16, ..., its lanes
  // consecutive columns), sums at float64 in a fixed order per thread, then
  // over the lanes (fixed shuffle tree) and the warps in order (the
  // [NB][D_WARPS] warp sums past the tile).
  using TC = typename std::conditional<OUT_F32, float, double>::type;
  TC* Cs = reinterpret_cast<TC*>(dsm);
#pragma unroll
  for (int i = 0; i < D_FM; ++i)
#pragma unroll
    for (int j = 0; j < D_FN; ++j) {
      if (i >= live_m || j >= live_n) continue;
      // C (16 x 8): c0 (g, 2k), c1 (g, 2k + 1), c2 (g + 8, 2k),
      // c3 (g + 8, 2k + 1)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = (wm * D_FM + i) * 16 + g + 8 * (c >> 1);
        const int q = (wn * D_FN + j) * 8 + 2 * k4 + (c & 1);
        if (p < nrows && q < ncols) Cs[p * D_LDC + q] = (TC)acc[i][j][c];
      }
    }
  __syncthreads();
  double* red = dsm + d_red_offset(OUT_F32);
  const double* wt = w + (size_t)row0 * PF + col0;
  for (int n0 = 0; n0 < NB; n0 += D_SLOTS) {
    double s[D_SLOTS];
#pragma unroll
    for (int k = 0; k < D_SLOTS; ++k) s[k] = 0.0;
    for (int p = warp; p < nrows; p += D_WARPS) {
#pragma unroll 2
      for (int q = lane; q < ncols; q += 32) {
        const double c = (double)Cs[p * D_LDC + q];
        const double* wp = wt + (size_t)p * PF + q;
#pragma unroll
        for (int k = 0; k < D_SLOTS; ++k)
          if (n0 + k < NB)
            s[k] = fma(c, __ldg(wp + (size_t)(n0 + k) * PL * PF), s[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < D_SLOTS; ++k) {
      if (n0 + k >= NB) continue;
      double v = s[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[(n0 + k) * D_WARPS + warp] = v;
    }
  }
  __syncthreads();
  for (int n = tid; n < NB; n += D_THREADS) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < D_WARPS; ++k) s += red[n * D_WARPS + k];
    if (ntiles > 1)
      partial[((size_t)r * ntiles + tile) * NB + n] = s;
    else if (OUT_F32)
      static_cast<float*>(out)[(size_t)r * NB + n] = (float)s;
    else
      static_cast<double*>(out)[(size_t)r * NB + n] = s;
  }
}

template <bool OUT_F32>
int launch_dmma(const Launch& a) {
  const size_t smem = (size_t)d_smem(OUT_F32, a.NB);
  auto kernel = corr_f64_kernel<OUT_F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.R, (unsigned)(a.ntl * a.ntf));
  kernel<<<grid, D_THREADS, smem, a.stream>>>(
      static_cast<const double*>(a.res_l), static_cast<const double*>(a.res_f),
      static_cast<const double*>(a.w), a.out, static_cast<double*>(a.partial),
      a.R, a.PL, a.PF, a.T, a.NB, a.ntf);
  if (a.ntl * a.ntf > 1) {
    const double* part = static_cast<const double*>(a.partial);
    if (OUT_F32)
      launch_reduce<double, float>(part, static_cast<float*>(a.out), a.R,
                                   a.ntl * a.ntf, a.NB, a.stream);
    else
      launch_reduce<double, double>(part, static_cast<double*>(a.out), a.R,
                                    a.ntl * a.ntf, a.NB, a.stream);
  }
  return 0;
}

// the warp tiles both kernels are instantiated for (binned_corr.py::
// WARP_TILES)
#define FPT_WARP_TILES(X) \
  X(1, 1) X(1, 2) X(1, 4) X(1, 7) X(2, 4) X(2, 7) X(2, 8)

}  // namespace fpt

// C entries, one per binning variant, with one contract: res_l (R, PL, T),
// res_f (R, PF, T), w (NB, PL, PF), out (R, NB), all float32 and
// contiguous; partial (R, ntiles, NB) scratch when the pair space needs more
// than one tile, else null. Return cudaGetLastError() after the launch(es),
// or cudaErrorInvalidValue for a tiling the source has no kernel for.
//
// `tiling` packs binned_corr.py::mma_tiling's warp grid as wgm | fm << 4 |
// fn << 8; the pair tiles are BM = PL rounded up to 16 and BN = PF rounded
// up to 8, each at most 128. fpt_binned_corr chooses its realizations per
// block itself (rb_max); fpt_binned_corr_vpu takes them as rb << 12
// (binned_corr.py::vpu_tiling, 1 <= rb <= VPU_RB).
extern "C" int fpt_binned_corr(const void* res_l, const void* res_f,
                               const void* w, void* out, void* partial,
                               int R, int PL, int PF, int T, int NB,
                               int tiling, int bf16, int shared,
                               void* stream) {
  using namespace fpt;
  Launch a;
  if (!decode(a, res_l, res_f, w, out, partial, R, PL, PF, T, NB, tiling,
              bf16, shared, stream))
    return (int)cudaErrorInvalidValue;
  int rc;
#define FPT_SHAPE(FM_, FN_) \
  if (a.fm == FM_ && a.fn == FN_) rc = launch_mma<FM_, FN_>(a); else
  FPT_WARP_TILES(FPT_SHAPE)
  return (int)cudaErrorInvalidValue;
#undef FPT_SHAPE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int fpt_binned_corr_vpu(const void* res_l, const void* res_f,
                                   const void* w, void* out, void* partial,
                                   int R, int PL, int PF, int T, int NB,
                                   int tiling, int bf16, int shared,
                                   void* stream) {
  using namespace fpt;
  Launch a;
  if (!decode(a, res_l, res_f, w, out, partial, R, PL, PF, T, NB, tiling,
              bf16, shared, stream) ||
      a.rb < 1 || a.rb > VPU_RB)
    return (int)cudaErrorInvalidValue;
  int rc;
#define FPT_SHAPE(FM_, FN_) \
  if (a.fm == FM_ && a.fn == FN_) rc = launch_vpu<FM_, FN_>(a); else
  FPT_WARP_TILES(FPT_SHAPE)
  return (int)cudaErrorInvalidValue;
#undef FPT_SHAPE
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The shared-memory bytes fpt_binned_corr_vpu requests for these
// arguments (binned_corr.py::vpu_smem must agree), or -1 for a tiling it
// refuses.
extern "C" long long fpt_binned_corr_vpu_smem(int PL, int PF, int NB,
                                              int tiling, int bf16,
                                              int shared) {
  using namespace fpt;
  Launch a;
  if (!decode(a, nullptr, nullptr, nullptr, nullptr, nullptr, 1, PL, PF, 1,
              NB, tiling, bf16, shared, nullptr) ||
      a.rb < 1 || a.rb > VPU_RB)
    return -1;
  return (long long)vpu_layout(PL, PF, NB, a.fm, a.fn, a.wgm, a.rb, a.f32,
                               a.dual).floats * (long long)sizeof(float);
}

// #1 on a float64 batch, one contract with fpt_binned_corr's but res_l,
// res_f and w float64 and partial float64 scratch. bf16 = 0: the DMMA kernel
// (corr_f64_kernel, which reads no warp tiling: the pair tiles are BM = PL
// rounded up to 16 and BN = PF rounded up to 8, each at most 128, as
// fpt_binned_corr's), out float32 (out_f64 = 0: the fused flavour) or
// float64 (out_f64 = 1: chunk_stats' pass 2). bf16 = 1: fpt_binned_corr's
// bf16 kernel at `tiling` on the float64 rows, each rounded to bf16 through
// float32, the float32 pair sums binned at float64, out float32 (out_f64 must be 0).
// Returns cudaGetLastError() after the launch(es), or cudaErrorInvalidValue
// for arguments it has no kernel for.
extern "C" int fpt_binned_corr_f64(const void* res_l, const void* res_f,
                                   const void* w, void* out, void* partial,
                                   int R, int PL, int PF, int T, int NB,
                                   int tiling, int bf16, int shared,
                                   int out_f64, void* stream) {
  using namespace fpt;
  Launch a;
  if (!decode(a, res_l, res_f, w, out, partial, R, PL, PF, T, NB, tiling,
              bf16, shared, stream))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (bf16) {
    if (out_f64) return (int)cudaErrorInvalidValue;
#define FPT_SHAPE(FM_, FN_)                                       \
  if (a.fm == FM_ && a.fn == FN_)                                 \
    rc = launch_mma<FM_, FN_, double, double, float>(a);          \
  else
    FPT_WARP_TILES(FPT_SHAPE)
    return (int)cudaErrorInvalidValue;
#undef FPT_SHAPE
  } else {
    // the epilogue's tile and warp sums fit one block's shared memory
    if (d_smem(!out_f64, NB) > 232448) return (int)cudaErrorInvalidValue;
    rc = out_f64 ? launch_dmma<false>(a) : launch_dmma<true>(a);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
