// K2: pairwise IBS0/IBS1/IBS2 counts from genotype class codes.
//
// Replaces hail_tpu/ops/ibs.py `_ibs_pallas_kernel`. A code is 0 hom-ref,
// 1 het, 2 hom-var, 3 missing. For every sample pair (i, j):
//   IBS0 = #variants where one is hom-ref and the other hom-var
//   IBS1 = #variants where one is het and the other homozygous
//   IBS2 = #variants where both are called, less IBS0 and IBS1
// into three full symmetric int32 (n, n) outputs.
//
// Bound on the H100 at 16,384 variants x 1,000 samples: bytes. 16.4 MB of
// codes in and 12 MB of counts out take 0.0085 ms at 3.35 TB/s. The function
// needs five products of 0/1 indicator matrices of depth m over the pairs
// i <= j (the outputs are symmetric),
//   IBS0 = hrᵀ·hv + hvᵀ·hr,  IBS1 = hetᵀ·homo + homoᵀ·het,
//   shared = calledᵀ·called,
// 2·5·m·n(n+1)/2 = 82.0 GOP on one-bit operands: 0.005 ms at eight times the
// card's 1,979 TOP/s of dense int8 (no one-bit peak is published; the 1-bit
// MMA issues at the int8 MMA's rate with eight times its depth, measured by
// csrc/bench/mma_rate.cu). As int8 products they would take 0.041 ms.
//
// Design. An indicator is one bit, and a product of 0/1 indicators is an AND
// followed by a count: the tensor cores do exactly that in
// mma.sync.m16n8k256 (b1 x b1 -> s32, and.popc), at the instruction rate of
// the int8 m16n8k32 on this card (measured: csrc/bench/mma_rate.cu) with
// eight times its depth. So the products run on one-bit operands, exact in
// int32.
// - Both operands want the depth (the variants) contiguous per sample and
//   the codes arrive variant-major, one byte each. A first small kernel
//   (`code_bit_planes_kernel`) turns them into two bit planes per sample,
//   the low and the high bit of the code, 32 variants to a word (a warp
//   ballot over 32 variants of one sample), in scratch the wrapper
//   allocates: planes (n_pad, 2, m_pad / 8) bytes, padded with code 3
//   (missing: sets no indicator) to whole 64-sample tiles and 1,024-variant
//   stages. Every 16-byte cp.async of the main kernel is then aligned and
//   in bounds, and it moves 0.25 bytes per code.
// - The indicators never exist in memory. A block stages bit planes only (a
//   ring of three stages of its 64 i-samples and 64 j-samples, rows of
//   128 + 16 bytes so that the eight rows of an ldmatrix fall into
//   different banks); a warp fetches the low and the high plane as MMA
//   fragments with ldmatrix, and each of the five indicator fragments is one
//   logic operation on the pair (`expand`).
// - A block owns a 64 x 64 tile of pairs, four warps with 32 x 32 each:
//   three int32 accumulators per pair, five MMAs per 16 x 8 tile and 256
//   variants (IBS0 and IBS1 are two MMAs each into one accumulator: the
//   doubled depth [hr | hv]·[hv | hr]). Only tiles on or above the diagonal
//   are computed; an element (i, j) with j >= i is added to (i, j) and, if
//   j > i, to (j, i), so the outputs stay full matrices for half the
//   products.
// - A small sample count gives few tiles (136 at n = 1,000), so the variants
//   may be split over gridDim.z blocks (`pick_splits`); every block adds its
//   counts to the zeroed outputs with integer atomics, exact in any order.
//
// nvcc 12.8 -Xptxas -v for sm_90a: the main kernel 199 registers, no spills,
// 110,592 bytes of dynamic shared memory (two blocks per SM); the plane
// kernel 28 registers, 8,320 bytes. Measured on an H100 (PERF.md): the call
// takes about ten times the bound above. The MMAs themselves would take
// 0.01 ms at the measured mma.sync rate; what is left is the plane kernel
// (about a third), the planes streaming from L2 into the tiles, the atomics
// and the zeroing. Next: the planes made inside the main kernel's load, and
// tiles written without atomics.

#include "common.cuh"

namespace {

constexpr int kTile = 64;        // samples per tile edge
constexpr int kKT = 128;         // bytes of one bit plane per stage
constexpr int kStageVariants = 8 * kKT;
constexpr int kLD = kKT + 16;    // shared-memory row stride, bytes
constexpr int kStages = 3;
constexpr int kThreads = 128;    // 2 x 2 warps, 32 x 32 pairs each
// a stage: the i-samples' low plane, their high plane, the j-samples' two
constexpr int kStageBytes = 4 * kTile * kLD;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kChunks = 4 * kTile * (kKT / 16);

// the indicator bits of 32 codes from their low and high bit planes
struct Indicators {
  unsigned hr, het, hv, homo, called;
};

__device__ __forceinline__ Indicators expand(unsigned lo, unsigned hi) {
  Indicators x;
  x.hr = ~(lo | hi);
  x.het = lo & ~hi;
  x.hv = hi & ~lo;
  x.homo = ~lo;
  x.called = ~(lo & hi);
  return x;
}

// codes (m, n) variant-major -> planes (n_pad, 2, m_pad / 8): per sample the
// low bits of its codes, then the high bits, variant v in bit v % 32 of word
// v / 32; code 3 where there is no sample or no variant. A block moves 128
// variants x 64 samples through shared memory: bytes in along the samples,
// then a warp takes 32 variants of one sample at a time and two ballots
// make the sample's two words.
constexpr int kTrV = 128;
constexpr int kTrS = 64;
constexpr int kTrLD = kTrS + 1;  // odd: the 32 rows of a ballot hit 32 banks

__global__ void __launch_bounds__(256)
code_bit_planes_kernel(const int8_t* __restrict__ codes, int m, int n,
                       unsigned* __restrict__ planes, int plane_words) {
  __shared__ int8_t tile[kTrV * kTrLD];
  const int v0 = blockIdx.x * kTrV;
  const int s0 = blockIdx.y * kTrS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;     // 8 warps
#pragma unroll 4
  for (int vv = warp; vv < kTrV; vv += 8) {
    const long long v = v0 + vv;
#pragma unroll
    for (int h = 0; h < kTrS / 32; ++h) {
      const int sl = lane + 32 * h;
      const int smp = s0 + sl;
      tile[vv * kTrLD + sl] = (v < m && smp < n) ? codes[v * n + smp] : 3;
    }
  }
  __syncthreads();
  const int vg = warp & 3;               // which 32 of the 128 variants
  const int sh = warp >> 2;              // which 32 of the 64 samples
  unsigned lo = 0, hi = 0;               // lane l keeps sample 32 sh + l
#pragma unroll 8
  for (int sl = 0; sl < 32; ++sl) {
    const int c = tile[(32 * vg + lane) * kTrLD + 32 * sh + sl];
    const unsigned l = __ballot_sync(0xffffffffu, c & 1);
    const unsigned h = __ballot_sync(0xffffffffu, c & 2);
    if (lane == sl) {
      lo = l;
      hi = h;
    }
  }
  unsigned* row = planes + (long long)(s0 + 32 * sh + lane) * 2 * plane_words +
                  v0 / 32 + vg;
  row[0] = lo;
  row[plane_words] = hi;
}

__global__ void __launch_bounds__(kThreads, 2)
ibs_counts_kernel(const int8_t* __restrict__ planes, int plane_bytes, int n,
                  int stages_per_block, int32_t* __restrict__ ibs0,
                  int32_t* __restrict__ ibs1, int32_t* __restrict__ ibs2) {
  extern __shared__ __align__(16) int8_t smem[];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  if (j0 < i0) return;                    // below the diagonal: mirrored
  const int st_begin = blockIdx.z * stages_per_block;
  const int n_stages = min(plane_bytes / kKT - st_begin, stages_per_block);
  if (n_stages <= 0) return;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wi = (tid >> 5) >> 1;         // the warp's 32 x 32 quarter
  const int wj = (tid >> 5) & 1;

  auto load_stage = [&](int stage, int t) {
    int8_t* sb = smem + stage * kStageBytes;
    const long long b0 = (long long)(st_begin + t) * kKT;
#pragma unroll
    for (int idx = tid; idx < kChunks; idx += kThreads) {
      const int row = idx / (kKT / 16);   // 64 rows each: i low, i high,
      const int off = (idx - row * (kKT / 16)) * 16;          // j low, j high
      const int sub = row / kTile;
      const int sample = (sub < 2 ? i0 : j0) + row - sub * kTile;
      cp_async16(sb + row * kLD + off,
                 planes + ((long long)sample * 2 + (sub & 1)) * plane_bytes +
                     b0 + off,
                 16);
    }
  };

  int c0[2][4][4], c1[2][4][4], csh[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) c0[a][b][e] = c1[a][b][e] = csh[a][b][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<kStages - 2>();         // stage t has landed
    __syncthreads();                      // ... for every thread, and stage
                                          // t - 1 is no longer read
    if (t + kStages - 1 < n_stages)
      load_stage((t + kStages - 1) % kStages, t + kStages - 1);
    cp_async_commit();

    const int8_t* sb = smem + (t % kStages) * kStageBytes;
    const int8_t* a_ptr = sb +
        (wi * 32 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLD +
        16 * (lane >> 4);
    const int8_t* b_ptr = sb +
        (2 * kTile + wj * 32 + (lane & 7) + 8 * (lane >> 4)) * kLD +
        16 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < kKT / 32; ++ks) {
      // B fragments of the warp's four 8-sample j-tiles, expanded once
      Indicators bj[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned lo[4], hi[4];
        ldmatrix_x4(lo, b_ptr + 16 * p * kLD + 32 * ks);
        ldmatrix_x4(hi, b_ptr + (kTile + 16 * p) * kLD + 32 * ks);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bj[2 * p + (q >> 1)][q & 1] = expand(lo[q], hi[q]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned lo[4], hi[4];
        ldmatrix_x4(lo, a_ptr + 16 * mi * kLD + 32 * ks);
        ldmatrix_x4(hi, a_ptr + (kTile + 16 * mi) * kLD + 32 * ks);
        unsigned hr[4], het[4], hv[4], homo[4], called[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Indicators x = expand(lo[q], hi[q]);
          hr[q] = x.hr; het[q] = x.het; hv[q] = x.hv; homo[q] = x.homo;
          called[q] = x.called;
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const Indicators& y0 = bj[nj][0];
          const Indicators& y1 = bj[nj][1];
          mma_b1(c0[mi][nj], hr, y0.hv, y1.hv);
          mma_b1(c0[mi][nj], hv, y0.hr, y1.hr);
          mma_b1(c1[mi][nj], het, y0.homo, y1.homo);
          mma_b1(c1[mi][nj], homo, y0.het, y1.het);
          mma_b1(csh[mi][nj], called, y0.called, y1.called);
        }
      }
    }
  }

  // D fragment: lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of
  // each 16 x 8 tile
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wi * 32 + mi * 16 + g + 8 * (e >> 1);
        const int j = j0 + wj * 32 + nj * 8 + 2 * tq + (e & 1);
        if (j < i || j >= n) continue;    // i <= j < n
        const int v0 = c0[mi][nj][e];
        const int v1 = c1[mi][nj][e];
        const int v2 = csh[mi][nj][e] - v0 - v1;
        const long long o = (long long)i * n + j;
        atomicAdd(ibs0 + o, v0);
        atomicAdd(ibs1 + o, v1);
        atomicAdd(ibs2 + o, v2);
        if (j > i) {
          const long long ot = (long long)j * n + i;
          atomicAdd(ibs0 + ot, v0);
          atomicAdd(ibs1 + ot, v1);
          atomicAdd(ibs2 + ot, v2);
        }
      }
    }
  }
}

// How many blocks share the variants of one tile. An SM's time is about its
// blocks times their stages, and every extra slice adds each count once
// more with an atomic (weighed as five stages a slice): the least sum.
int pick_splits(long long upper_tiles, int stages, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= stages && s <= 64; ++s) {
    const long long per_sm = (upper_tiles * s + sms - 1) / sms;
    const long long cost = per_sm * ((stages + s - 1) / s) + 5LL * s;
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// codes (m, n) int8; planes: scratch of n_pad x 2 x m_pad / 8 bytes, 16-byte
// aligned, n_pad and m_pad the multiples of 64 and 1,024 at or above n and m
// (the first kernel fills all of it). ibs0, ibs1, ibs2 (n, n) must be
// zeroed: blocks add into them.
HAIL_API int hail_ibs_counts(const void* codes, int m, int n, void* planes,
                             int m_pad, int n_pad, void* ibs0, void* ibs1,
                             void* ibs2, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      ibs_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  code_bit_planes_kernel<<<dim3((unsigned)(m_pad / kTrV),
                                (unsigned)(n_pad / kTrS)),
                           256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, m, n, (unsigned*)planes, m_pad / 32);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = n_pad / kTile;
  const int stages = m_pad / kStageVariants;
  const int splits =
      pick_splits((long long)tiles * (tiles + 1) / 2, stages, sms);
  const int stages_per_block = (stages + splits - 1) / splits;
  const unsigned nz =
      (unsigned)((stages + stages_per_block - 1) / stages_per_block);
  ibs_counts_kernel<<<dim3((unsigned)tiles, (unsigned)tiles, nz), kThreads,
                      kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)planes, m_pad / 8, n, stages_per_block, (int32_t*)ibs0,
      (int32_t*)ibs1, (int32_t*)ibs2);
  return (int)cudaGetLastError();
}
