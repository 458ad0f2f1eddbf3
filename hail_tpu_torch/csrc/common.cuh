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

// ---- int8 tensor-core and async-copy building blocks (K2, K3) -------------
//
// mma.sync.m16n8k32 s8 x s8 -> s32, D = A·B + D, one warp. With g = lane / 4
// and t = lane % 4 a lane holds, four int8 to a register:
//   A (16 x 32, row-major):  a[0] row g,     k 4t..4t+3     a[1] row g + 8, same k
//                            a[2] row g,     k 16+4t..      a[3] row g + 8, k 16+4t..
//   B (32 x 8, "col": k contiguous per column):
//                            b0 column g, k 4t..4t+3        b1 column g, k 16+4t..
//   D (16 x 8, int32):       d[0], d[1] row g,     columns 2t, 2t + 1
//                            d[2], d[3] row g + 8, columns 2t, 2t + 1
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync.m16n8k256 b1 and.popc: D += popcount(A & B) over 256 bits. The
// fragments are those of the int8 instruction above with a byte read as
// eight bits of the depth (bench/mma_rate.cu checks that on the card).
__device__ __forceinline__ void mma_b1(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8-row x 16-byte matrices from shared memory: lanes 8q..8q+7 give the
// row addresses of matrix q, and r[q] of lane l is the word at byte 4(l % 4)
// of row l / 4 of matrix q. That is an A fragment when the matrices are
// (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15,
// k 16-31) of a row-major tile, and the B fragments of two neighbouring
// 8-column tiles when they are (columns 0-7, k 0-15), (columns 0-7, k 16-31),
// (columns 8-15, k 0-15), (columns 8-15, k 16-31) of a tile held column by
// column.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes from global to shared memory without passing through registers;
// only the first `bytes` (0 or 16 here) are read, the rest is zero-filled.
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem_dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` of this thread's newest groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
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
