// K4: 2-bit genotype codes -> the cached (gz8, m8) int8 pair.
//
// Replaces hail_tpu/ops/linreg_i8.py `unpack_gt_2bit` (XLA-compiled in the
// reference). u8 (R, ceil(n/4)) holds four codes per byte, the first entry
// in the low bits; code 3 is missing. Output gz8 = code (0 where missing)
// and m8 = [code == 3], both int8 (R, n).
//
// Bound on the H100: device memory. The pass reads 0.25 B and writes 2 B
// per entry and does a few integer operations, so it can only go as fast
// as HBM takes the writes. Design: one thread per packed byte, consecutive
// threads on consecutive bytes, so the reads are coalesced and the four
// byte stores of neighbouring threads fall in the same 128-byte lines. A
// grid-stride loop covers any R·ceil(n/4) with a capped grid. Fusing this
// into K3's load, so that the pass reads 0.25 B/entry, is later work.

#include "common.cuh"

__global__ void unpack_gt_2bit_kernel(const uint8_t* __restrict__ u8,
                                      long long R, int n4, int n,
                                      int8_t* __restrict__ gz,
                                      int8_t* __restrict__ m) {
  const long long total = R * (long long)n4;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / n4;
    const int q = (int)(idx - r * n4);
    const unsigned byte = u8[idx];
    int8_t* gz_row = gz + r * n;
    int8_t* m_row = m + r * n;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * q + k;
      if (col < n) {
        const int code = (byte >> (2 * k)) & 3;
        const int miss = code == 3;
        gz_row[col] = (int8_t)(miss ? 0 : code);
        m_row[col] = (int8_t)miss;
      }
    }
  }
}

HAIL_API int hail_unpack_gt_2bit(const void* u8, long long R, int n4, int n,
                                 void* gz, void* m, void* stream) {
  const long long total = R * (long long)n4;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 65536) blocks = 65536;
    unpack_gt_2bit_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)u8, R, n4, n, (int8_t*)gz, (int8_t*)m);
  }
  return (int)cudaGetLastError();
}
