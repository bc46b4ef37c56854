// Shared pieces of the port's kernels (binned_corr.cu, megakernel.cu): the
// staged TOA tile width, bf16 rounding and loads, the fixed-order second
// pass over pair tiles (at float32 or float64) and the error-string entry.
// Every sum runs in a fixed order and no float atomic is used anywhere, so a
// rerun is bit-identical.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fpt {

constexpr int TT = 32;        // TOAs per shared-memory tile

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Second pass over pair tiles: out[r, n] = sum_k partial[r, k, n], k in
// order, summed at the partials' type and written at the output's (the
// float64 kernels sum float64 partials and write float32 or float64).
template <typename TP, typename TO>
__global__ void reduce_tiles(const TP* __restrict__ partial,
                             TO* __restrict__ out, int R, int ntiles,
                             int NB) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)R * NB) return;
  const long r = idx / NB, n = idx % NB;
  TP s = 0;
  for (int k = 0; k < ntiles; ++k) s += partial[(r * ntiles + k) * NB + n];
  out[idx] = (TO)s;
}

template <typename TP, typename TO>
inline int launch_reduce(const TP* partial, TO* out, int R, int ntiles,
                         int NB, cudaStream_t stream) {
  const long total = (long)R * NB;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  reduce_tiles<TP, TO><<<blocks, threads, 0, stream>>>(partial, out, R,
                                                       ntiles, NB);
  return 0;
}

}  // namespace fpt

extern "C" const char* fpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
