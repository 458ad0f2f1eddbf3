// K3: the exact linreg pass, one read of the (gz8, m8) pair.
//
// Replaces the two int8 dot_generals and the three row sums of
// hail_tpu/ops/linreg_i8.py `_exact_core` (XLA-compiled in the reference):
//   GWd = gz8 · Wdig, MWd = m8 · Wdig       int8 x int8 -> int32, (R, C)
//   nmiss = Σ m8, s = Σ gz8, ss = Σ gz8²     int32, (R,)
// where Wdig (N, C) stacks the digit planes of W = [Q | Ys] (C = planes·KP,
// 35 at the bench shape). The kernel takes WT (Cp, ldw): Wdig transposed,
// row C all ones, zero-padded to Cp = 8·(C/8 + 1) rows and to ldw, a
// multiple of 16 ≥ N (ops/linreg_i8.exact_operand builds it once per phenotype
// group). Sums are exact in int32 while N·max|g|·127 < 2³¹, which the caller
// checks.
//
// Bound on the H100 at 8,192 x 10,000, C = 35: bytes. gz8 + m8 are 163.84 MB
// read once (0.049 ms at 3.35 TB/s; WT, 0.4 MB, and the outputs, 2.4 MB, add
// 0.001); the 2·2·40 int8 operations per entry are 13.1 GOP, 0.007 ms at
// 1,979 TOP/s. So the kernel is a stream of G through shared memory with the
// products on the tensor cores beside it.
//
// Design. A block owns 64 variant rows and walks the samples in stages of
// 128: a ring of four stages in dynamic shared memory, each holding the
// block's gz8 tile, its m8 tile and the WT tile of the stage, filled with
// 16-byte cp.async copies (three stages in flight per block, 16 KB of G
// each) and consumed by eight warps: warps 0-3 multiply the gz8 tile and
// warps 4-7 the m8 tile, 16 rows each, against the same WT tile with
// mma.sync.m16n8k32 (s8 x s8 -> s32), operands fetched with ldmatrix. A
// shared-memory row is 128 + 16 bytes, so the eight 16-byte rows of an
// ldmatrix fall into different banks. Σgz8 and Σm8 come out of the product
// as its column C (the row of ones in WT); Σgz8² is a dp4a of the A
// fragment with itself, one instruction per register, reduced over the four
// lanes that share a row. 8,192 rows are 128 blocks for 132 SMs: 64-row
// tiles fill the card in one wave with no atomics and no zeroed outputs.
// The sample tail is zero-filled in shared memory (cp.async reads 0 bytes of
// a chunk past N, and rows past R), never read past the row. When a row of
// G is not 16-byte aligned (N % 16 != 0, or an offset base), the G tiles are
// staged through registers with 4-byte or single-byte loads (`load4`)
// instead; WT is aligned by construction. Columns are covered in chunks of
// 48 (C + 1 <= 48) or 96; each further chunk reads G again.
//
// nvcc 12.8 -Xptxas -v for sm_90a: 70 registers at 48 columns and 106 at 96,
// no spills, one barrier; 101,376 and 129,024 bytes of dynamic shared
// memory. Measured on an H100 (PERF.md): about half of the bound. A build
// with the MMAs taken out streamed only a little faster, so what is left is
// the stream itself (128-byte pieces of 128 rows per stage), not the
// products.

#include "common.cuh"

namespace {

constexpr int kRows = 64;        // variant rows per block
constexpr int kKT = 128;         // samples per stage
constexpr int kLD = kKT + 16;    // shared-memory row stride, bytes
constexpr int kStages = 4;
constexpr int kWarpsPerOp = kRows / 16;        // 16 rows per warp
constexpr int kThreads = 2 * kWarpsPerOp * 32;  // first half of the warps:
                                                // gz8 · WT, second: m8 · WT
constexpr int kCPR = kKT / 16;   // 16-byte chunks per tile row

template <int NP>
__host__ __device__ constexpr int stage_bytes() {
  return (2 * kRows + 16 * NP) * kLD;   // gz8 tile, m8 tile, 16·NP WT columns
}

// NP: pairs of 8-column MMA tiles per column chunk
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
linreg_exact_pass_kernel(const int8_t* __restrict__ gz,
                         const int8_t* __restrict__ m,
                         const int8_t* __restrict__ WT, int ldw, int R, int N,
                         int C, int Cp, int32_t* __restrict__ GWd,
                         int32_t* __restrict__ MWd,
                         int32_t* __restrict__ nmiss, int32_t* __restrict__ s,
                         int32_t* __restrict__ ss) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int kCols = 16 * NP;
  constexpr int kStageBytes = stage_bytes<NP>();
  constexpr int kChunks = (2 * kRows + kCols) * kCPR;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int which = warp / kWarpsPerOp;   // 0: gz8, 1: m8
  const int wr = (warp % kWarpsPerOp) * 16;   // the warp's first tile row
  const long long row0 = (long long)blockIdx.x * kRows;
  const bool fast = (N & 15) == 0 && ((uintptr_t)gz & 15) == 0 &&
                    ((uintptr_t)m & 15) == 0;
  const bool al4 = (N & 3) == 0 && ((uintptr_t)gz & 3) == 0 &&
                   ((uintptr_t)m & 3) == 0;
  const int n_tiles = (N + kKT - 1) / kKT;

  for (int c0 = 0; c0 < Cp; c0 += kCols) {
    auto load_stage = [&](int stage, int t) {
      int8_t* sb = smem + stage * kStageBytes;
      const int n0 = t * kKT;
      for (int idx = tid; idx < kChunks; idx += kThreads) {
        const int row = idx / kCPR;
        const int off = (idx - row * kCPR) * 16;
        const int k = n0 + off;
        int8_t* dst = sb + row * kLD + off;
        if (row >= 2 * kRows) {
          const int c = c0 + row - 2 * kRows;
          const bool ok = c < Cp && k < ldw;
          cp_async16(dst, WT + (ok ? (long long)c * ldw + k : 0),
                     ok ? 16 : 0);
        } else {
          const long long r = row0 + (row & (kRows - 1));
          const bool ok = r < R && k < N;
          const int8_t* src =
              (row < kRows ? gz : m) + (ok ? r * N + k : 0);
          if (fast) {
            cp_async16(dst, src, ok ? 16 : 0);
          } else {
            int w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int left = ok ? N - k - 4 * q : 0;
              w[q] = left > 0 ? load4(src + 4 * q, left, al4) : 0;
            }
            *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    };

    int acc[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    int sq_lo = 0, sq_hi = 0;             // Σgz8² of rows g and g + 8

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) load_stage(st, st);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();       // tile t has landed
      __syncthreads();                    // ... for every thread, and tile
                                          // t - 1 is no longer read
      if (t + kStages - 1 < n_tiles)
        load_stage((t + kStages - 1) % kStages, t + kStages - 1);
      cp_async_commit();

      const int8_t* sb = smem + (t % kStages) * kStageBytes;
      const int8_t* a_ptr = sb +
          (which * kRows + wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLD +
          16 * (lane >> 4);
      const int8_t* b_ptr = sb +
          (2 * kRows + (lane & 7) + 8 * (lane >> 4)) * kLD +
          16 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < kKT / 32; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, a_ptr + 32 * ks);
        if (which == 0 && c0 == 0) {
          sq_lo = __dp4a((int)a[0], (int)a[0], sq_lo);
          sq_hi = __dp4a((int)a[1], (int)a[1], sq_hi);
          sq_lo = __dp4a((int)a[2], (int)a[2], sq_lo);
          sq_hi = __dp4a((int)a[3], (int)a[3], sq_hi);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          unsigned b[4];
          ldmatrix_x4(b, b_ptr + 16 * p * kLD + 32 * ks);
          mma_s8(acc[2 * p], a, b[0], b[1]);
          mma_s8(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }

    // D fragment: lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of
    // every 8-column tile
    const int g = lane >> 2;
    const int tq = lane & 3;
    int32_t* out = which ? MWd : GWd;
    int32_t* sum_out = which ? nmiss : s;
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = row0 + wr + g + 8 * (e >> 1);
        const int c = c0 + 8 * j + 2 * tq + (e & 1);
        if (r < R) {
          if (c < C) out[r * C + c] = acc[j][e];
          else if (c == C) sum_out[r] = acc[j][e];
        }
      }
    }
    if (which == 0 && c0 == 0) {
      sq_lo += __shfl_xor_sync(0xffffffffu, sq_lo, 1);
      sq_lo += __shfl_xor_sync(0xffffffffu, sq_lo, 2);
      sq_hi += __shfl_xor_sync(0xffffffffu, sq_hi, 1);
      sq_hi += __shfl_xor_sync(0xffffffffu, sq_hi, 2);
      if (tq == 0) {
        const long long r = row0 + wr + g;
        if (r < R) ss[r] = sq_lo;
        if (r + 8 < R) ss[r + 8] = sq_hi;
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next column chunk
  }
}

template <int NP>
int launch_exact_pass(const void* gz, const void* m, const void* WT, int ldw,
                      int R, int N, int C, int Cp, void* GWd, void* MWd,
                      void* nmiss, void* s, void* ss, cudaStream_t stream) {
  constexpr int smem_bytes = kStages * stage_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      linreg_exact_pass_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + kRows - 1) / kRows);
  linreg_exact_pass_kernel<NP><<<blocks, kThreads, smem_bytes, stream>>>(
      (const int8_t*)gz, (const int8_t*)m, (const int8_t*)WT, ldw, R, N, C,
      Cp, (int32_t*)GWd, (int32_t*)MWd, (int32_t*)nmiss, (int32_t*)s,
      (int32_t*)ss);
  return (int)cudaGetLastError();
}

}  // namespace

// WT (Cp, ldw) as ops/linreg_i8.exact_operand lays it out: 16-byte aligned, ldw a
// multiple of 16 >= N, Cp a multiple of 8 > C, row C all ones
HAIL_API int hail_linreg_exact_pass(const void* gz, const void* m,
                                    const void* WT, int ldw, int R, int N,
                                    int C, int Cp, void* GWd, void* MWd,
                                    void* nmiss, void* s, void* ss,
                                    void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (Cp <= 48)
    return launch_exact_pass<3>(gz, m, WT, ldw, R, N, C, Cp, GWd, MWd, nmiss,
                                s, ss, (cudaStream_t)stream);
  return launch_exact_pass<6>(gz, m, WT, ldw, R, N, C, Cp, GWd, MWd, nmiss, s,
                              ss, (cudaStream_t)stream);
}
