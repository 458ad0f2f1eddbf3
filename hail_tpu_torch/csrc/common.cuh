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
