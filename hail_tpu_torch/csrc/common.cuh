// Shared helpers of the port's hand-written kernels. Every entry point has
// a plain C interface (loaded with ctypes), launches on the stream it is
// given and returns cudaGetLastError() so the caller sees a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define HAIL_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// four consecutive int8 at p (zero past `left` entries) as one word
__device__ __forceinline__ int load4(const int8_t* p, int left, bool aligned) {
  if (aligned && left >= 4) return *reinterpret_cast<const int*>(p);
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < left) v |= (unsigned)(uint8_t)p[b] << (8 * b);
  return (int)v;
}
