// Shared pieces of the statistic kernels (binned_corr.cu, megakernel.cu).
//
// A "realization group" is 256 threads laid out 16 x 16. It owns one
// realization's (rows x cols) correlation tile, 16*MT pulsars a side, held in
// registers: thread (ty, tx) accumulates the pairs (ty + 16 i, tx + 16 j).
// T is consumed in shared-memory tiles of TT TOAs, stored transposed
// ([t][p], row stride LD = 16*MT + 1 to keep the transposing stores free of
// bank conflicts). Every sum runs in a fixed order and no float atomic is
// used anywhere, so a rerun is bit-identical.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fpt {

constexpr int TT = 32;        // TOAs per shared-memory tile
constexpr int TDIM = 16;      // threads per side of a realization group
constexpr int GROUP = TDIM * TDIM;
constexpr int GROUP_WARPS = GROUP / 32;
constexpr int MAX_MT = 8;     // a pair tile is at most 128 x 128 pulsars

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// acc[i][j] += sum_t A[t][ty + 16 i] * B[t][tx + 16 j] over one T tile.
template <int MT>
__device__ __forceinline__ void corr_tile(const float* A, const float* B,
                                          int ld, int ty, int tx,
                                          float (&acc)[MT][MT]) {
#pragma unroll 2
  for (int t = 0; t < TT; ++t) {
    float a[MT], b[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = A[t * ld + ty + TDIM * i];
#pragma unroll
    for (int j = 0; j < MT; ++j) b[j] = B[t * ld + tx + TDIM * j];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Weighted reduction of a group's correlation tile into NB slots:
//   dst[n] = sum_{p,q in tile} corr[p, q] * w[n, row0 + p, col0 + q].
// Each thread sums its own pairs, a warp folds with a fixed shuffle tree,
// and thread n adds the group's warp sums in warp order. `red` is this
// group's [NB][GROUP_WARPS] scratch. Every thread of the block must call
// this (it holds a __syncthreads); `gtid` is the thread's index in its group
// and `dst` may be null (a ragged block's idle group).
template <int MT>
__device__ void bin_group(const float (&acc)[MT][MT],
                          const float* __restrict__ w, int NB, int PL, int PF,
                          int row0, int col0, int nrows, int ncols, int ty,
                          int tx, int gtid, float* red, float* dst) {
  const int warp = gtid >> 5, lane = gtid & 31;
  for (int n = 0; n < NB; ++n) {
    const float* wn = w + (size_t)n * PL * PF;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p = ty + TDIM * i;
      if (p >= nrows) continue;
      const float* wrow = wn + (size_t)(row0 + p) * PF + col0;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int q = tx + TDIM * j;
        if (q < ncols) s = fmaf(acc[i][j], wrow[q], s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[n * GROUP_WARPS + warp] = s;
  }
  __syncthreads();
  if (dst != nullptr) {
    for (int n = gtid; n < NB; n += GROUP) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < GROUP_WARPS; ++k) s += red[n * GROUP_WARPS + k];
      dst[n] = s;
    }
  }
}

// Second pass over pair tiles: out[r, n] = sum_k partial[r, k, n], k in order.
__global__ void reduce_tiles(const float* __restrict__ partial,
                             float* __restrict__ out, int R, int ntiles,
                             int NB) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * NB) return;
  const long r = idx / NB, n = idx % NB;
  float s = 0.f;
  for (int k = 0; k < ntiles; ++k) s += partial[(r * ntiles + k) * NB + n];
  out[idx] = s;
}

inline int launch_reduce(const float* partial, float* out, int R, int ntiles,
                         int NB, cudaStream_t stream) {
  const long total = (long)R * NB;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  reduce_tiles<<<blocks, threads, 0, stream>>>(partial, out, R, ntiles, NB);
  return 0;
}

}  // namespace fpt

extern "C" const char* fpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
