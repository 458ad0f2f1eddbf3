// K5: every per-variant QC counter of a block of packed calls, in one pass.
//
// Replaces hail_tpu/ops/qc.py `variant_qc_block` (XLA-compiled in the
// reference): for each row r of packed int32 calls (R, C) with a bool
// missing mask, and optional DP and GQ (R, C) int32 with -1 for missing,
//   counts (8, R) int32: n_called, n_het, n_hom_ref_diploid,
//     n_hom_var_diploid, n_non_ref, AN, dp_n, gq_n;
//   ac, hom (R, A) int32: AC and homozygote_count, A = max_alleles;
//   stats (8, R) f64: dp_sum, dp_sumsq, dp_min, dp_max, gq_sum, gq_sumsq,
//     gq_min, gq_max (min +inf and max -inf in a row with no defined value).
// The semantics are the reference's one-hot formulas (ops/qc.py:31-71):
//   - a call counts only where `missing` is clear (the packed bits under a
//     missing entry are arbitrary);
//   - ploidy = p & 3, j = p >> 3 & 0x3FFF, k = p >> 17 & 0x7FFF; j counts
//     in AC where ploidy >= 1, k where ploidy == 2; n_non_ref is
//     j > 0 || (ploidy == 2 && k > 0); AN sums the ploidy;
//   - an allele at or above A is counted in no AC or homozygote column;
//   - DP and GQ count wherever they are >= 0, whatever the call.
// DP and GQ sums are f64, as in the reference; the squares are rounded
// before they are added (no FMA), so with values below 2^26 every partial
// sum is the exact integer and the result is bit-equal in any order.
//
// Bound on the H100: device memory. A row of C entries is read once, 13 B
// per entry with DP and GQ (4 packed, 1 missing, 4 + 4), and the outputs
// are a few words per row: 2,048 x 10,000 is 266 MB, 0.080 ms at 3.35 TB/s.
// The reference's XLA version materializes three (R, C, A) one-hot tensors
// and reduces each counter apart; here nothing leaves the registers but
// the row totals.
//
// Design (simple first; wider loads and several rows per block are later
// work). One block of 256 threads per row, the threads striding its
// columns, so consecutive threads read consecutive words. Each thread
// keeps its counters in registers: the scalar counts, and the AC and
// homozygote counts of alleles 0 and 1 (all of a biallelic row).
// Alleles 2..A-1 go to a shared-memory histogram of 2A int32 (dynamic
// shared memory; A is a runtime argument) by shared atomics. At the end
// each counter is summed across the warp by shuffles, across the eight
// warps through shared memory, and the register allele counts are added
// into the histogram, which the block then writes out.

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// per-thread int counters, in this order: 11 summed, then 2 min, 2 max
constexpr int kSums = 11;
constexpr int kInts = kSums + 4;

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct FieldAcc {
  double sum = 0.0, sumsq = 0.0;
  int n = 0, mn = INT_MAX, mx = -1;

  __device__ __forceinline__ void add(int v) {
    if (v < 0) return;   // the missing sentinel (and any negative value)
    const double d = (double)v;
    sum = __dadd_rn(sum, d);
    sumsq = __dadd_rn(sumsq, __dmul_rn(d, d));
    ++n;
    mn = min(mn, v);
    mx = max(mx, v);
  }
};

__global__ void __launch_bounds__(kThreads)
variant_qc_kernel(const int* __restrict__ packed,
                  const uint8_t* __restrict__ missing,
                  const int* __restrict__ dp, const int* __restrict__ gq,
                  int R, int C, int A, bool has_dp, bool has_gq,
                  int* __restrict__ counts,
                  int* __restrict__ ac, int* __restrict__ hom,
                  double* __restrict__ stats) {
  extern __shared__ int s_hist[];   // [0, A): AC, [A, 2A): homozygote
  __shared__ int s_int[kWarps][kInts];
  __shared__ double s_f64[kWarps][4];
  const int r = blockIdx.x;
  for (int a = threadIdx.x; a < 2 * A; a += kThreads) s_hist[a] = 0;
  __syncthreads();

  const long long base = (long long)r * C;
  const int* prow = packed + base;
  const uint8_t* mrow = missing + base;
  // n_called, n_het, n_hom_ref_diploid (= homozygote count of allele 0),
  // n_hom_var_diploid, n_non_ref, AN, AC of alleles 0 and 1, homozygote
  // count of allele 1
  int n_called = 0, n_het = 0, n_hrd = 0, n_hvd = 0, n_non_ref = 0, an = 0;
  int ac0 = 0, ac1 = 0, hom1 = 0;
  FieldAcc fdp, fgq;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += kThreads) {
    if (has_dp) fdp.add(__ldg(dp + base + c));
    if (has_gq) fgq.add(__ldg(gq + base + c));
    if (__ldg(mrow + c)) continue;
    const int p = __ldg(prow + c);
    const int ploidy = p & 3;
    const int j = (p >> 3) & 0x3FFF;
    const int k = (p >> 17) & 0x7FFF;
    const bool dip = ploidy == 2;
    ++n_called;
    an += ploidy;
    n_het += dip && j != k;
    n_hrd += dip && j == 0 && k == 0;
    n_hvd += dip && j == k && j > 0;
    n_non_ref += j > 0 || (dip && k > 0);
    if (ploidy >= 1) {
      if (j == 0) ++ac0;
      else if (j == 1) ++ac1;
      else if (j < A) atomicAdd(&s_hist[j], 1);
    }
    if (dip) {
      if (k == 0) ++ac0;
      else if (k == 1) ++ac1;
      else if (k < A) atomicAdd(&s_hist[k], 1);
      if (j == k) {
        if (j == 1) ++hom1;
        else if (j >= 2 && j < A) atomicAdd(&s_hist[A + j], 1);
      }
    }
  }

  int v[kInts] = {n_called, n_het, n_hrd, n_hvd, n_non_ref, an, ac0, ac1,
                  hom1, fdp.n, fgq.n, fdp.mn, fgq.mn, fdp.mx, fgq.mx};
  double f[4] = {fdp.sum, fdp.sumsq, fgq.sum, fgq.sumsq};
#pragma unroll
  for (int i = 0; i < kSums; ++i) v[i] = warp_sum(v[i]);
  v[11] = warp_min(v[11]);
  v[12] = warp_min(v[12]);
  v[13] = warp_max(v[13]);
  v[14] = warp_max(v[14]);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = warp_sum_f64(f[i]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < kInts; ++i) s_int[warp][i] = v[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) s_f64[warp][i] = f[i];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int t[kInts];
    double tf[4] = {0.0, 0.0, 0.0, 0.0};
    for (int i = 0; i < kInts; ++i) t[i] = s_int[0][i];
    for (int i = 0; i < 4; ++i) tf[i] = s_f64[0][i];
    for (int w = 1; w < kWarps; ++w) {
      for (int i = 0; i < kSums; ++i) t[i] += s_int[w][i];
      t[11] = min(t[11], s_int[w][11]);
      t[12] = min(t[12], s_int[w][12]);
      t[13] = max(t[13], s_int[w][13]);
      t[14] = max(t[14], s_int[w][14]);
      for (int i = 0; i < 4; ++i) tf[i] = __dadd_rn(tf[i], s_f64[w][i]);
    }
    counts[0 * (long long)R + r] = t[0];
    counts[1 * (long long)R + r] = t[1];
    counts[2 * (long long)R + r] = t[2];
    counts[3 * (long long)R + r] = t[3];
    counts[4 * (long long)R + r] = t[4];
    counts[5 * (long long)R + r] = t[5];
    if (A >= 1) {
      s_hist[0] += t[6];
      s_hist[A] += t[2];
    }
    if (A >= 2) {
      s_hist[1] += t[7];
      s_hist[A + 1] += t[8];
    }
    const int* fn = t + 9;   // dp_n, gq_n
    const int* fmn = t + 11;
    const int* fmx = t + 13;
    for (int q = 0; q < 2; ++q) {
      if (!(q == 0 ? has_dp : has_gq)) continue;
      counts[(6 + q) * (long long)R + r] = fn[q];
      stats[(4 * q + 0) * (long long)R + r] = tf[2 * q];
      stats[(4 * q + 1) * (long long)R + r] = tf[2 * q + 1];
      stats[(4 * q + 2) * (long long)R + r] = fn[q] ? (double)fmn[q] : INFINITY;
      stats[(4 * q + 3) * (long long)R + r] = fn[q] ? (double)fmx[q] : -INFINITY;
    }
  }
  __syncthreads();

  int* ac_row = ac + (long long)r * A;
  int* hom_row = hom + (long long)r * A;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    ac_row[a] = s_hist[a];
    hom_row[a] = s_hist[A + a];
  }
}

}  // namespace

// `fields`: bit 0 set when DP is given, bit 1 when GQ is (a pointer cannot
// say so: an empty tensor's may be null)
HAIL_API int hail_variant_qc(const void* packed, const void* missing,
                             const void* dp, const void* gq, long long R,
                             int C, int A, int fields, void* counts, void* ac,
                             void* hom, void* stats, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (R > INT_MAX || C < 0 || A < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)A * sizeof(int);
  if (smem > 48 * 1024) {
    // above 48 KB a block takes dynamic shared memory only by opting in
    const cudaError_t e = cudaFuncSetAttribute(
        variant_qc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  variant_qc_kernel<<<(unsigned)R, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)packed, (const uint8_t*)missing, (const int*)dp,
      (const int*)gq, (int)R, C, A, (fields & 1) != 0, (fields & 2) != 0,
      (int*)counts, (int*)ac, (int*)hom, (double*)stats);
  return (int)cudaGetLastError();
}
