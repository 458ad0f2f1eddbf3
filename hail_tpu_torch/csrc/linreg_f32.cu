// K1: the f32 one-pass linreg sums, one read of int8 G.
//
// Replaces the Pallas kernel hail_tpu/ops/linreg_i8.py `_kernel` (launched
// at :103 by `_pallas_sums_call`). From G int8 (R, N), -1 = missing, and
// W f32 (N, KP) = [Q | Ys] it computes in one pass over G
//   GW = Gz · W, MW = M · W        f32 (R, KP), Gz = max(G, 0), M = [G < 0]
//   ST = [ΣM, ΣGz, ΣGz²]            f32 (R, 3)
// with plain f32 FMAs on CUDA cores: the reference asks for true-f32
// products (Precision.HIGHEST), so no TF32 and no tensor cores. g·w is exact
// for g in {0, 1, 2}; only the order of the sums differs from the plain
// torch version. The row sums are integers, exact in f32 while below 2²⁴,
// which the caller checks (`_MAX_F32_N`). The kernel takes W transposed and
// zero-padded, WT (KP, ldw) with ldw a multiple of 4 ≥ N, so that four
// consecutive samples of one column are one 16-byte load.
//
// Bound on the H100: at the bench partition (8,192 x 10,000, KP = 5) the
// pass reads 82 MB of G, about 25 µs of HBM, and issues about 2·CB FMAs per
// entry, of the same order on the CUDA cores: neither bound dominates, so
// the design keeps both streams moving. It is K3's skeleton (linreg_exact.cu):
// one warp per variant row, eight rows per block; the block stages a tile
// of WT (CB columns x TN samples) in shared memory with unrolled 16-byte
// loads and all eight warps read it, a lane taking four consecutive samples
// of a column as one float4 (neighbouring lanes on neighbouring 16 bytes,
// no bank conflicts). Each lane loads all its G words of a tile (four
// samples per 32-bit load) before it computes, so a tile waits on memory
// about once. Lanes keep 2·CB + 3 f32 partial sums in registers and reduce
// them with warp shuffles at the end. KP is covered in chunks of CB = 8
// columns (one chunk at the bench shape); each further chunk reads G again.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                // variant rows per block
constexpr int kCB = 8;                   // columns of WT per chunk
constexpr int kTN = 1024;                // samples per staged WT tile
constexpr int kJ = kTN / 128;            // 4-sample words per lane per tile
constexpr int kChunks = kCB * kTN / 4;   // 16-byte chunks per tile
constexpr int kThreads = kWarps * 32;
static_assert(kChunks % kThreads == 0, "tile staging is unrolled evenly");

// byte q of a word as a signed int8 value
__device__ __forceinline__ int byte_at(int word, int q) {
  return (int)((unsigned)word << (24 - 8 * q)) >> 24;
}

__global__ void __launch_bounds__(kThreads)
linreg_i8_sums_kernel(const int8_t* __restrict__ G,
                      const float* __restrict__ WT, int ldw, int R, int N,
                      int KP, float* __restrict__ GW, float* __restrict__ MW,
                      float* __restrict__ ST) {
  __shared__ __align__(16) float Ws[kCB * kTN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  const bool live = row < R;
  const bool aligned = (N & 3) == 0 && ((uintptr_t)G & 3) == 0;
  const int8_t* g_row = G + (live ? row : 0) * (long long)N;

  for (int c0 = 0; c0 < KP; c0 += kCB) {
    const int cw = min(kCB, KP - c0);
    float acc_g[kCB];
    float acc_m[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      acc_g[c] = 0.f;
      acc_m[c] = 0.f;
    }
    float n_miss = 0.f, sum_g = 0.f, sum_gg = 0.f;

    for (int n0 = 0; n0 < N; n0 += kTN) {
      __syncthreads();   // the previous tile is no longer read
#pragma unroll
      for (int k = 0; k < kChunks / kThreads; ++k) {
        const int idx = threadIdx.x + k * kThreads;
        const int c = idx / (kTN / 4);
        const int col = n0 + 4 * (idx - c * (kTN / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < cw && col < ldw)
          v = *reinterpret_cast<const float4*>(
              WT + (long long)(c0 + c) * ldw + col);
        reinterpret_cast<float4*>(Ws)[idx] = v;
      }
      __syncthreads();
      if (live) {
        int g4[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int i = 4 * lane + 128 * j;
          const int left = N - n0 - i;
          g4[j] = left > 0 ? load4(g_row + n0 + i, left, aligned) : 0;
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int i = 4 * lane + 128 * j;
          float gz[4], mf[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int g = byte_at(g4[j], q);
            mf[q] = g < 0 ? 1.f : 0.f;
            gz[q] = g < 0 ? 0.f : (float)g;
            n_miss += mf[q];
            sum_g += gz[q];
            sum_gg = fmaf(gz[q], gz[q], sum_gg);
          }
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            const float4 w = *reinterpret_cast<const float4*>(Ws + c * kTN + i);
            acc_g[c] = fmaf(gz[0], w.x, acc_g[c]);
            acc_g[c] = fmaf(gz[1], w.y, acc_g[c]);
            acc_g[c] = fmaf(gz[2], w.z, acc_g[c]);
            acc_g[c] = fmaf(gz[3], w.w, acc_g[c]);
            acc_m[c] = fmaf(mf[0], w.x, acc_m[c]);
            acc_m[c] = fmaf(mf[1], w.y, acc_m[c]);
            acc_m[c] = fmaf(mf[2], w.z, acc_m[c]);
            acc_m[c] = fmaf(mf[3], w.w, acc_m[c]);
          }
        }
      }
    }

    if (live) {
      float* gw_out = GW + row * (long long)KP + c0;
      float* mw_out = MW + row * (long long)KP + c0;
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const float vg = warp_sum(acc_g[c]);
        const float vm = warp_sum(acc_m[c]);
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
          ST[row * 3] = n_miss;
          ST[row * 3 + 1] = sum_g;
          ST[row * 3 + 2] = sum_gg;
        }
      }
    }
  }
}

}  // namespace

HAIL_API int hail_linreg_i8_sums(const void* G, const void* WT, int ldw,
                                 int R, int N, int KP, void* GW, void* MW,
                                 void* ST, void* stream) {
  if (R > 0 && KP > 0) {
    const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
    linreg_i8_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)G, (const float*)WT, ldw, R, N, KP, (float*)GW,
        (float*)MW, (float*)ST);
  }
  return (int)cudaGetLastError();
}
