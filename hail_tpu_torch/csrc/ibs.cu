// K2: pairwise IBS0/IBS1/IBS2 counts from genotype class codes.
//
// Replaces hail_tpu/ops/ibs.py `_ibs_pallas_kernel`. codes int8 (m, n):
// 0 hom-ref, 1 het, 2 hom-var, 3 missing, one row per variant. For every
// sample pair (i, j):
//   IBS0 = #variants where one is hom-ref and the other hom-var
//   IBS1 = #variants where one is het and the other homozygous
//   IBS2 = #variants where both are called, less IBS0 and IBS1
// into three int32 (n, n) outputs.
//
// Bound on the H100: integer issue rate. Read as indicator-matrix products
// the counts are 5 int8 GEMMs of depth m, but each indicator is one bit, so
// the kernel packs 32 variants of each class into one 32-bit mask per
// sample and counts with AND and popcount: one pair and 32 variants cost
// about a dozen integer instructions, and the codes are read once per
// 64-sample tile edge, so HBM is far from the limit; what costs is latency
// with too few warps per SM. Design: a block owns a 64 x 64 tile of pairs
// and one slice of the variants, 256 threads with 4 x 4 pairs each and
// three int32 counters per pair in registers (capped at 128 registers, two
// blocks per SM). Blocks run in no order, so the TPU's accumulation over a
// sequential variant grid axis becomes a loop inside the block: per stage
// it turns 128 variants of the tile's 64 + 64 samples into hom-ref / het /
// hom-var masks in shared memory, syncs, and every thread folds them into
// its counters. A small sample count gives few tiles (256 at n = 1,000),
// so the variants are split over enough blocks to fill the card four
// times over, and each block adds its counts to the zeroed outputs with
// integer atomics (exact, in any order). Padding samples and variants read
// as missing and set no bit.

#include "common.cuh"

namespace {

constexpr int kTile = 64;     // samples per tile edge
constexpr int kWords = 4;     // 32-variant words per stage
constexpr int kSub = 4;       // pairs per thread along each edge

// masks[side][class][word][sample]; class 0 hom-ref, 1 het, 2 hom-var
__device__ __forceinline__ void build_masks(const int8_t* __restrict__ codes,
                                            int v_end, int n, int v0, int s0,
                                            uint32_t (*masks)[kWords][kTile]) {
  const int t = threadIdx.x;            // 256 threads: (word, sample)
  const int w = t / kTile;
  const int smp = t - w * kTile;
  const int col = s0 + smp;
  const int vbase = v0 + 32 * w;
  uint32_t hr = 0, het = 0, hv = 0;
  // unrolled, so the 32 loads issue back to back and the thread waits on
  // memory once per stage, not once per variant
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int v = vbase + b;
    const int code =
        (col < n && v < v_end) ? codes[(long long)v * n + col] : 3;
    hr |= (uint32_t)(code == 0) << b;
    het |= (uint32_t)(code == 1) << b;
    hv |= (uint32_t)(code == 2) << b;
  }
  masks[0][w][smp] = hr;
  masks[1][w][smp] = het;
  masks[2][w][smp] = hv;
}

__global__ void __launch_bounds__(256, 2)
ibs_counts_kernel(const int8_t* __restrict__ codes, int m, int n,
                  int v_chunk, int32_t* __restrict__ ibs0,
                  int32_t* __restrict__ ibs1, int32_t* __restrict__ ibs2) {
  __shared__ uint32_t mi[3][kWords][kTile];
  __shared__ uint32_t mj[3][kWords][kTile];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int ti = threadIdx.x / (kTile / kSub);   // 0..15
  const int tj = threadIdx.x % (kTile / kSub);   // 0..15

  int c0[kSub][kSub], c1[kSub][kSub], csh[kSub][kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) c0[a][b] = c1[a][b] = csh[a][b] = 0;

  const int v_begin = blockIdx.z * v_chunk;
  const int v_end = min(m, v_begin + v_chunk);
  for (int v0 = v_begin; v0 < v_end; v0 += 32 * kWords) {
    __syncthreads();   // the previous stage's masks are no longer read
    build_masks(codes, v_end, n, v0, i0, mi);
    build_masks(codes, v_end, n, v0, j0, mj);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      uint32_t hr_i[kSub], he_i[kSub], hv_i[kSub];
      uint32_t hr_j[kSub], he_j[kSub], hv_j[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const int si = ti + a * (kTile / kSub);
        const int sj = tj + a * (kTile / kSub);
        hr_i[a] = mi[0][w][si]; he_i[a] = mi[1][w][si]; hv_i[a] = mi[2][w][si];
        hr_j[a] = mj[0][w][sj]; he_j[a] = mj[1][w][sj]; hv_j[a] = mj[2][w][sj];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const uint32_t homo_i = hr_i[a] | hv_i[a];
        const uint32_t call_i = homo_i | he_i[a];
#pragma unroll
        for (int b = 0; b < kSub; ++b) {
          const uint32_t homo_j = hr_j[b] | hv_j[b];
          const uint32_t call_j = homo_j | he_j[b];
          // the two terms of each count are disjoint: a sample holds one
          // class per variant
          c0[a][b] += __popc((hr_i[a] & hv_j[b]) | (hv_i[a] & hr_j[b]));
          c1[a][b] += __popc((he_i[a] & homo_j) | (homo_i & he_j[b]));
          csh[a][b] += __popc(call_i & call_j);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = i0 + ti + a * (kTile / kSub);
    if (i >= n) continue;
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      const int j = j0 + tj + b * (kTile / kSub);
      if (j >= n) continue;
      const long long o = (long long)i * n + j;
      atomicAdd(ibs0 + o, c0[a][b]);
      atomicAdd(ibs1 + o, c1[a][b]);
      atomicAdd(ibs2 + o, csh[a][b] - c0[a][b] - c1[a][b]);
    }
  }
}

}  // namespace

// ibs0, ibs1, ibs2 must be zeroed: blocks add into them
HAIL_API int hail_ibs_counts(const void* codes, int m, int n, void* ibs0,
                             void* ibs1, void* ibs2, void* stream) {
  if (n > 0 && m > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long tiles = (n + kTile - 1) / kTile;
    const int stages = (m + 32 * kWords - 1) / (32 * kWords);
    long long splits = (4LL * sms + tiles * tiles - 1) / (tiles * tiles);
    if (splits > stages) splits = stages;
    if (splits < 1) splits = 1;
    const int v_chunk =
        (int)((stages + splits - 1) / splits) * 32 * kWords;
    const unsigned nz = (unsigned)((m + v_chunk - 1) / v_chunk);
    ibs_counts_kernel<<<dim3((unsigned)tiles, (unsigned)tiles, nz), 256, 0,
                        (cudaStream_t)stream>>>(
        (const int8_t*)codes, m, n, v_chunk, (int32_t*)ibs0, (int32_t*)ibs1,
        (int32_t*)ibs2);
  }
  return (int)cudaGetLastError();
}
