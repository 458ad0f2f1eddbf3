// K7: the digit planes of the exact linreg's operand, made on the card.
//
// Replaces no TPU kernel: hail_tpu/ops/linreg_i8.py `_digit_planes` is numpy
// on the host in the reference too. It was added because on this card that
// host decomposition set the pace of a phenotype sweep: at 361,194 samples x
// 42 columns it takes 2.2-2.4 s of one core per call, while the card does
// the same work in one read and one write of memory.
//
// W = [Q | Ys] (N, KP) f64, read through Q (N, k) and Ys (N, P), row-major,
// each through its own pointer. Per column the host gives base = 2^ceil(
// log2(max |w|)) (1 for a zero column), and the kernel writes the 7 signed
// 7-bit digits of each entry that `_digit_planes` computes:
//   resid = w / base; for d in 0..6:
//     x = resid * 128; q = clip(rint(x), -127, 127); digit d = q;
//     resid = x - q
// with rint rounding half to even (np.rint) and every step rounded on its
// own (__ddiv_rn, __dmul_rn, __dsub_rn: nothing is contracted into an FMA),
// so the digits are bit-equal to the host's on every input. Two outputs:
//   Wdig (N, C) int8, C = 7·KP, plane-major columns (digit d of column c at
//     column d·KP + c): the operand as `ExactOperand.Wdig` carries it;
//   WT (Cp, ldw) int8: K3's layout (ops/linreg_i8.exact_operand), Wdig
//     transposed, row C all ones over the N samples, zeros elsewhere,
//     Cp = 8·(C/8 + 1), ldw a multiple of 16 >= N.
// The kernel writes every byte of both, padding included.
// Two entry points, one launch each:
//   hail_digit_amax: max |w| per column, as the bits of a non-negative double
//     (their order is the numbers' order), by atomicMax into a zeroed (KP,)
//     buffer; the host turns the maxima into the bases with numpy's own
//     exp2(ceil(log2(.))) (the card's log2 need not round as numpy's does);
//   hail_digit_planes: the digits, given the bases.
//
// Bound on the H100 at 361,194 x 42 (k = 26, P = 16): bytes. W is 121.4 MB
// of f64 and is read twice, once for the maxima and once for the digits
// (the digits need the maxima of all rows first, and 121 MB does not stay in
// the 50 MB L2); Wdig (106.2 MB) and WT (106.9 MB) are written once: 455.9
// MB, 0.136 ms at 3.35 TB/s (W read once: 334.5 MB, 0.100 ms). Its f64 work,
// about 30 operations per entry (below), 0.5 GFLOP, is far below the card's
// f64 rate.
//
// Design. The maxima: each block walks rows of Q (y = 0) or Ys (y = 1) with
// a thread per (row in a step, column), so that neighbouring threads read
// neighbouring doubles of the row-major array; the block reduces each column
// in shared memory and makes one atomicMax per column. The digits: a block
// owns 64 rows and up to 64 columns of W (gridDim.y tiles wider W). It
// reads its rows of Q and Ys in memory order, thread e on entry e of the
// block's rows, and writes the 7 digits of each entry into a tile in shared
// memory held digit column by digit column (WT's layout: a tile row is the
// block's 64 samples of one digit column, 68 bytes apart, so the 32 columns
// of a warp's writes fall into 32 banks). Per entry the f64 work is one
// multiply by 1/base (exact where 1/base is a double; a division where it
// is not) and, per digit, a multiply, the rint of `x + 1.5·2^52` (whose low
// word is the digit), a clip and a subtract, all on the f64 pipe. From the
// tile the block writes WT as 64-byte runs of each digit column, 4 bytes a
// thread, and, when one tile holds every column, Wdig a warp per row, lane
// l on columns l, l + 32, ... (32 neighbouring bytes a store, 32 banks a
// read). W, WT and Wdig thus move in whole sectors.
//
// nvcc 12.8 -Xptxas -v for sm_90a: 40 registers, no spills, 33,664 bytes
// of static shared memory. Measured on an H100 (PERF.md): 0.265 ms at
// 361,194 x 42, the maxima 0.052 of it; 0.38 of the bound above, 0.51 of
// the two-pass bound. Variants tried on the card: the Wdig pass with 16
// bytes a thread (16-way bank conflicts) and rint / int conversions on
// their own instructions, 6% and 2% slower; every load of a thread issued
// before its first use, 122 registers, 33% slower (fewer blocks resident).

#include "common.cuh"

namespace {

constexpr int kPlanes = 7;
constexpr int kThreads = 256;
constexpr int kRows = 64;          // rows (samples) of W per block
constexpr int kCols = 64;          // columns of W per block, at most
constexpr int kLd = kRows + 4;     // tile row stride: 17 words, odd

__global__ void __launch_bounds__(kThreads)
digit_amax_kernel(const double* __restrict__ Q, int k,
                  const double* __restrict__ Ys, int P, int N,
                  unsigned long long* __restrict__ amax) {
  __shared__ unsigned long long part[kThreads];
  const double* src = blockIdx.y == 0 ? Q : Ys;
  const int nc = blockIdx.y == 0 ? k : P;
  unsigned long long* out = blockIdx.y == 0 ? amax : amax + k;
  for (int c0 = 0; c0 < nc; c0 += kThreads) {
    const int cw = min(nc - c0, kThreads);
    const int rstep = kThreads / cw;          // rows a step of the block reads
    const int c = threadIdx.x % cw;
    const int rs = threadIdx.x / cw;
    unsigned long long m = 0ull;
    if (rs < rstep) {
      for (long long r = (long long)blockIdx.x * rstep + rs; r < N;
           r += (long long)gridDim.x * rstep) {
        const unsigned long long b = (unsigned long long)__double_as_longlong(
            fabs(src[r * nc + c0 + c]));
        m = b > m ? b : m;
      }
    }
    part[threadIdx.x] = m;
    __syncthreads();
    if (threadIdx.x < cw) {
      for (int j = 1; j < rstep; ++j) {
        const unsigned long long b = part[threadIdx.x + j * cw];
        m = b > m ? b : m;
      }
      atomicMax(out + c0 + threadIdx.x, m);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
digit_planes_kernel(const double* __restrict__ Q, int k,
                    const double* __restrict__ Ys, int P, int N,
                    const double* __restrict__ base,
                    int8_t* __restrict__ Wdig, int8_t* __restrict__ WT,
                    int ldw, int Cp) {
  __shared__ __align__(16) int8_t tile[kPlanes * kCols][kLd];
  __shared__ short tile_of[kPlanes * kCols];  // the block's digit column ->
  __shared__ int wt_of[kPlanes * kCols];      // its tile row and WT row
  __shared__ double inv[kCols];             // 1 / base, where exact
  const int KP = k + P;
  const int C = kPlanes * KP;
  const int r0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int tc = min(kCols, KP - c0);        // the block's columns of W
  const int tid = threadIdx.x;

  if (tid < tc) {
    // w / 2^e and w · 2^-e round the same real number, so they are equal
    // wherever 2^-e is a double (1 / base finite and not 0); else inv is 0
    // and the column's entries are divided
    const double v = __drcp_rn(base[c0 + tid]);
    inv[tid] = (isfinite(v) && v != 0.0) ? v : 0.0;
  }
  for (int j = tid; j < kPlanes * tc; j += kThreads) {
    const int d = j / tc, c = j % tc;
    tile_of[j] = (short)(d * kCols + c);
    wt_of[j] = d * KP + c0 + c;
  }
  __syncthreads();

  // the digits of the block's entries, into the tile; rows past N are 0.
  // rint(x) for |x| <= 128 is (x + 1.5·2^52) - 1.5·2^52, which rounds half
  // to even as np.rint does, and the low word of x + 1.5·2^52 is rint(x)
  // as an int: no conversion instructions, all on the f64 pipe.
  {
    constexpr double kMagic = 6755399441055744.0;   // 1.5·2^52
    const int step_r = kThreads / tc, step_c = kThreads % tc;
    int rl = tid / tc, c = tid % tc;
    for (int e = tid; e < kRows * tc; e += kThreads) {
      const int r = r0 + rl;
      const int gc = c0 + c;
      if (r < N) {
        const double w = gc < k ? Q[(long long)r * k + gc]
                                : Ys[(long long)r * P + gc - k];
        const double iv = inv[c];
        double resid = iv != 0.0 ? __dmul_rn(w, iv) : __ddiv_rn(w, base[gc]);
#pragma unroll
        for (int d = 0; d < kPlanes; ++d) {
          const double x = __dmul_rn(resid, 128.0);
          const double t = __dadd_rn(x, kMagic);
          double q = __dsub_rn(t, kMagic);
          // np.clip: a NaN passes through (its digit is 0, as (int)NaN)
          q = q < -127.0 ? -127.0 : (q > 127.0 ? 127.0 : q);
          const int qi = min(max(__double2loint(t), -127), 127);
          tile[d * kCols + c][rl] = (int8_t)(q == q ? qi : 0);
          resid = __dsub_rn(x, q);
        }
      } else {
#pragma unroll
        for (int d = 0; d < kPlanes; ++d) tile[d * kCols + c][rl] = 0;
      }
      rl += step_r;
      c += step_c;
      if (c >= tc) {
        c -= tc;
        ++rl;
      }
    }
  }
  __syncthreads();

  // WT: 64-byte runs of each digit column, 4 bytes a thread; the last
  // block's run stops at ldw (a multiple of 16)
  constexpr int kWords = kRows / 4;
  for (int i = tid; i < kPlanes * tc * kWords; i += kThreads) {
    const int j = i / kWords, q = i % kWords;
    const int r = r0 + 4 * q;
    if (r < ldw)
      *reinterpret_cast<int*>(WT + (long long)wt_of[j] * ldw + r) =
          *reinterpret_cast<const int*>(&tile[tile_of[j]][4 * q]);
  }
  // rows C..Cp-1 of WT: ones over the samples in row C, zeros elsewhere
  if (blockIdx.y == 0) {
    for (int i = tid; i < (Cp - C) * kWords; i += kThreads) {
      const int row = C + i / kWords;
      const int r = r0 + 4 * (i % kWords);
      if (r < ldw) {
        unsigned v = 0u;
        if (row == C)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (r + b < N) v |= 1u << (8 * b);
        *reinterpret_cast<unsigned*>(WT + (long long)row * ldw + r) = v;
      }
    }
  }

  // Wdig, rows r0..r1 of the block
  const int r1 = min(r0 + kRows, N);
  if (r1 <= r0) return;
  if (gridDim.y == 1) {
    // every column in this tile: a warp writes whole rows, lane l the
    // columns l, l + 32, ...: 32 neighbouring bytes a store, and the 32
    // bytes it reads lie in 32 neighbouring tile rows, 17 words apart, so
    // in 32 banks. The tile offset of each of a lane's columns is kept in
    // a register across the rows.
    constexpr int kMaxJ = (kPlanes * kCols + 31) / 32;
    const int lane = tid & 31;
    int toff[kMaxJ];
#pragma unroll
    for (int m = 0; m < kMaxJ; ++m) {
      const int j = lane + 32 * m;
      toff[m] = j < C ? ((j / KP) * kCols + j % KP) * kLd : -1;
    }
    const int8_t* t0 = &tile[0][0];
    for (int rl = tid >> 5; rl < r1 - r0; rl += kThreads / 32) {
      int8_t* dst = Wdig + (long long)(r0 + rl) * C + lane;
#pragma unroll
      for (int m = 0; m < kMaxJ; ++m)
        if (toff[m] >= 0) dst[32 * m] = t0[toff[m] + rl];
    }
  } else {
    // a tile of wide W: the block's tc columns of each plane in each row
    const int per_row = kPlanes * tc;
    for (int i = tid; i < (r1 - r0) * per_row; i += kThreads) {
      const int rl = i / per_row, j = i % per_row;
      Wdig[(long long)(r0 + rl) * C + wt_of[j]] = tile[tile_of[j]][rl];
    }
  }
}

}  // namespace

// Q (N, k) and Ys (N, P) f64 row-major (Q may be null when k = 0); amax
// (k + P,) f64, zeroed by the caller: max |w| of each column of [Q | Ys].
HAIL_API int hail_digit_amax(const void* Q, int k, const void* Ys, int P,
                             int N, void* amax, void* stream) {
  if (N <= 0 || k + P <= 0) return (int)cudaGetLastError();
  int blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;           // a grid-stride loop
  digit_amax_kernel<<<dim3((unsigned)blocks, 2), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const double*)Q, k, (const double*)Ys, P, N,
      (unsigned long long*)amax);
  return (int)cudaGetLastError();
}

// base (k + P,) f64: each column's power of two; Wdig (N, 7·(k + P)) int8 and
// WT (Cp, ldw) int8 written whole. WT 4-byte aligned (ldw % 16 == 0), Wdig
// 16-byte aligned (the wrapper allocates both).
HAIL_API int hail_digit_planes(const void* Q, int k, const void* Ys, int P,
                               int N, const void* base, void* Wdig, void* WT,
                               int ldw, int Cp, void* stream) {
  if (N <= 0 || k + P <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((ldw + kRows - 1) / kRows),
                  (unsigned)((k + P + kCols - 1) / kCols));
  digit_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)Q, k, (const double*)Ys, P, N, (const double*)base,
      (int8_t*)Wdig, (int8_t*)WT, ldw, Cp);
  return (int)cudaGetLastError();
}
