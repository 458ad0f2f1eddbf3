// K3: the exact linreg pass, one read of the (gz8, m8) pair.
//
// Replaces the two int8 dot_generals and the three row sums of
// hail_tpu/ops/linreg_i8.py `_exact_core` (XLA-compiled in the reference):
//   GWd = gz8 · Wdig, MWd = m8 · Wdig       int8 x int8 -> int32, (R, C)
//   nmiss = Σ m8, s = Σ gz8, ss = Σ gz8²     int32, (R,)
// where Wdig (N, C) stacks the digit planes of W = [Q | Ys] (C = planes·KP,
// 35 at the bench shape). The kernel takes Wdig transposed and zero-padded,
// WT (C, ldw) with ldw a multiple of 16 ≥ N, so that four consecutive
// samples of one column are one 32-bit word and sixteen one 16-byte load.
// Sums are exact in int32 while N·max|g|·127 < 2³¹, which the caller checks.
//
// Bound on the H100: at C = 35 each entry of G costs 70 multiply-adds
// against 2 bytes of G read; as int8 products on CUDA cores that is issue-
// bound, not HBM-bound. Design: __dp4a does four int8 multiply-adds in one
// instruction, so a lane takes four consecutive samples at a time: one
// 32-bit load each of gz8 and m8, then for every column one 32-bit read of
// WT from shared memory and two dp4a (G and M), plus three dp4a for the row
// sums. One warp per variant row, eight rows per block; the block stages a
// tile of WT (CB columns x TN samples) in shared memory once and all eight
// warps read it, neighbouring lanes on neighbouring words (no bank
// conflicts). The staging is a few unrolled 16-byte loads per thread, and
// each lane loads all its G words of a tile before it computes, so a tile
// waits on memory about once, not once per load: a byte-wise staging loop
// would wait on some 80 L2 round trips per tile, which measured 8x slower
// on the card. Lanes keep 2·CB + 3 int32 partial sums in registers and reduce
// them with warp shuffles at the end. C is covered in chunks of CB = 40
// columns (one chunk at the bench shape); each further chunk reads G
// again. int8 tensor-core MMAs (wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;     // variant rows per block
constexpr int kCB = 40;       // columns of WT per chunk
constexpr int kTN = 512;      // samples per staged WT tile
constexpr int kJ = kTN / 128; // 4-sample words per lane per tile
constexpr int kChunks = kCB * kTN / 16;          // 16-byte chunks per tile
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads, 2)
linreg_exact_pass_kernel(const int8_t* __restrict__ gz,
                         const int8_t* __restrict__ m,
                         const int8_t* __restrict__ WT, int ldw, int R,
                         int N, int C,
                         int32_t* __restrict__ GWd, int32_t* __restrict__ MWd,
                         int32_t* __restrict__ nmiss, int32_t* __restrict__ s,
                         int32_t* __restrict__ ss) {
  __shared__ __align__(16) int8_t Ws[kCB * kTN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  const bool live = row < R;
  const bool aligned = (N & 3) == 0 && ((uintptr_t)gz & 3) == 0 &&
                       ((uintptr_t)m & 3) == 0;
  const int8_t* g_row = gz + (live ? row : 0) * (long long)N;
  const int8_t* m_row = m + (live ? row : 0) * (long long)N;
  const int ones = 0x01010101;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    const int cw = min(kCB, C - c0);
    int acc_g[kCB];
    int acc_m[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      acc_g[c] = 0;
      acc_m[c] = 0;
    }
    int n_miss = 0, sum_g = 0, sum_gg = 0;

    for (int n0 = 0; n0 < N; n0 += kTN) {
      __syncthreads();   // the previous tile is no longer read
#pragma unroll
      for (int k = 0; k < (kChunks + kThreads - 1) / kThreads; ++k) {
        const int idx = threadIdx.x + k * kThreads;
        if (idx < kChunks) {
          const int c = idx / (kTN / 16);
          const int col = n0 + 16 * (idx - c * (kTN / 16));
          int4 v = make_int4(0, 0, 0, 0);
          if (c < cw && col < ldw)
            v = *reinterpret_cast<const int4*>(
                WT + (long long)(c0 + c) * ldw + col);
          reinterpret_cast<int4*>(Ws)[idx] = v;
        }
      }
      __syncthreads();
      if (live) {
        int g4[kJ], m4[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int i = 4 * lane + 128 * j;
          const int left = N - n0 - i;
          g4[j] = left > 0 ? load4(g_row + n0 + i, left, aligned) : 0;
          m4[j] = left > 0 ? load4(m_row + n0 + i, left, aligned) : 0;
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int i = 4 * lane + 128 * j;
          n_miss = __dp4a(m4[j], ones, n_miss);
          sum_g = __dp4a(g4[j], ones, sum_g);
          sum_gg = __dp4a(g4[j], g4[j], sum_gg);
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            const int w4 = *reinterpret_cast<const int*>(Ws + c * kTN + i);
            acc_g[c] = __dp4a(g4[j], w4, acc_g[c]);
            acc_m[c] = __dp4a(m4[j], w4, acc_m[c]);
          }
        }
      }
    }

    if (live) {
      int32_t* gw_out = GWd + row * (long long)C + c0;
      int32_t* mw_out = MWd + row * (long long)C + c0;
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const int vg = warp_sum(acc_g[c]);
        const int vm = warp_sum(acc_m[c]);
        if (lane == 0 && c < cw) {
          gw_out[c] = vg;
          mw_out[c] = vm;
        }
      }
      if (c0 == 0) {
        n_miss = warp_sum(n_miss);
        sum_g = warp_sum(sum_g);
        sum_gg = warp_sum(sum_gg);
        if (lane == 0) {
          nmiss[row] = n_miss;
          s[row] = sum_g;
          ss[row] = sum_gg;
        }
      }
    }
  }
}

}  // namespace

HAIL_API int hail_linreg_exact_pass(const void* gz, const void* m,
                                    const void* WT, int ldw, int R, int N,
                                    int C,
                                    void* GWd, void* MWd, void* nmiss,
                                    void* s, void* ss, void* stream) {
  if (R > 0) {
    const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
    linreg_exact_pass_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)gz, (const int8_t*)m, (const int8_t*)WT, ldw, R, N, C,
        (int32_t*)GWd, (int32_t*)MWd, (int32_t*)nmiss, (int32_t*)s,
        (int32_t*)ss);
  }
  return (int)cudaGetLastError();
}
