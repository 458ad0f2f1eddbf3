// K4: 2-bit genotype codes -> the cached (gz8, m8) int8 pair.
//
// Replaces hail_tpu/ops/linreg_i8.py `unpack_gt_2bit` (XLA-compiled in the
// reference). u8 (R, ceil(n/4)) holds four codes per byte, the first entry
// in the low bits; code 3 is missing. Output gz8 = code (0 where missing)
// and m8 = [code == 3], both int8 (R, n). The pair is what ops/devcache
// keeps under ('gz8', ...) and what the exact pass, the GLM tier and the
// integer-x path read, so the unpack is a kernel of its own.
//
// Bound on the H100: device memory. The pass reads 0.25 B and writes 2 B
// per entry (8,192 x 10,000: 20.5 MB in, 163.8 MB out, 0.055 ms at 3.35
// TB/s) and has no reuse to stage, so it is a copy-shaped stream: what
// matters is that the bytes leave in few, wide instructions.
//
// Design. A thread owns one 16-byte piece of each output: it takes the 16
// codes of that piece as one 32-bit word and expands them in packed integer
// arithmetic, a byte of four codes to a word of four entries in two
// shift-or-mask steps (little-endian: the first entry, in the low bits,
// lands at the low address), then m = x & (x >> 1) & 0x01010101 and
// gz = x - 3 m, and writes each output with one 16-byte store,
// neighbouring threads on neighbouring 16 bytes. The outputs (164 MB) exceed
// the L2 cache (50 MB), so loads and stores are the streaming kind
// (`__ldcs`, `__stcs`; plain ones measured the same within 0.5%).
//   - Flat path (n % 4 == 0, u8 4-byte aligned): no row holds padding
//     codes, so word w of the whole input is entries 16w..16w+15 of the
//     whole output: one aligned 32-bit load, no row index and no division.
//     A thread takes kPer words a block-width apart, all loads first. 256
//     threads at 42 registers are five blocks, 1,280 threads, per SM, each
//     with up to eight 16-byte stores in flight. The up to three packed
//     bytes after the last whole word go entry by entry.
//   - General path (any n, any u8 base), same kernel and launch: rows by
//     blockIdx.y and a row loop, pieces by blockIdx.x. Row r starts at
//     output byte r n, a = r n mod 16 into a piece, so piece k of the row
//     holds columns 16k - a .. 16k - a + 15; their codes start 2 (c mod 4)
//     bits into packed byte floor(c / 4), so the thread gathers five bytes
//     (those outside the row read as 0) and funnel-shifts. Pieces wholly
//     inside the row are stored as 16 bytes, the two at its ends entry by
//     entry under 0 <= column < n, which also keeps the padding codes of the
//     row's last byte out.
// Both outputs must be 16-byte aligned at row 0 (the wrapper allocates
// them); the entry point refuses anything else.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;   // flat path: words per thread

// the four codes of byte q of `codes` -> (gz, m) words of four entries
__device__ __forceinline__ void expand4(unsigned codes, int q, unsigned& gz,
                                        unsigned& m) {
  const unsigned b = (codes >> (8 * q)) & 0xFFu;
  unsigned x = (b | (b << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  m = x & (x >> 1) & 0x01010101u;
  gz = x - 3u * m;
}

__device__ __forceinline__ void expand16(unsigned codes, uint4& gz, uint4& m) {
  expand4(codes, 0, gz.x, m.x);
  expand4(codes, 1, gz.y, m.y);
  expand4(codes, 2, gz.z, m.z);
  expand4(codes, 3, gz.w, m.w);
}

__device__ __forceinline__ void store16(int8_t* p, const uint4& v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// entries i of a piece with lo <= i < hi, one byte at a time
__device__ __forceinline__ void store_bytes(int8_t* p, const uint4& v, int lo,
                                            int hi) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i >= lo && i < hi) p[i] = (int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

__global__ void __launch_bounds__(kThreads)
unpack_gt_2bit_kernel(const uint8_t* __restrict__ u8, long long R, int n4,
                      int n, int8_t* __restrict__ gz, int8_t* __restrict__ m,
                      int flat) {
  if (flat) {
    const long long bytes = R * (long long)n4;
    const long long words = bytes >> 2;
    const long long first =
        (long long)blockIdx.x * (kThreads * kPer) + threadIdx.x;
    const unsigned* src = reinterpret_cast<const unsigned*>(u8);
    unsigned codes[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = first + (long long)k * kThreads;
      codes[k] = 0;
      if (w < words) codes[k] = __ldcs(src + w);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = first + (long long)k * kThreads;
      if (w < words) {
        uint4 vg, vm;
        expand16(codes[k], vg, vm);
        store16(gz + 16 * w, vg);
        store16(m + 16 * w, vm);
      } else if (w == words && bytes > 4 * words) {
        // the last one to three packed bytes of the input
        const int left = (int)(bytes - 4 * words);
        unsigned tail = 0;
        for (int b = 0; b < left; ++b)
          tail |= (unsigned)u8[4 * words + b] << (8 * b);
        uint4 vg, vm;
        expand16(tail, vg, vm);
        store_bytes(gz + 16 * w, vg, 0, 4 * left);
        store_bytes(m + 16 * w, vm, 0, 4 * left);
      }
    }
    return;
  }

  const int k = blockIdx.x * kThreads + threadIdx.x;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const long long o = r * (long long)n;   // the row's first output byte
    const int c0 = 16 * k - (int)(o & 15);  // the piece's first column
    if (c0 >= n) continue;
    const int b0 = c0 >> 2;                 // floor: c0 may be -15..-1
    const uint8_t* row = u8 + r * (long long)n4;
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (b0 + i >= 0 && b0 + i < n4) lo |= (unsigned)row[b0 + i] << (8 * i);
    if (b0 + 4 >= 0 && b0 + 4 < n4) hi = row[b0 + 4];
    uint4 vg, vm;
    expand16(__funnelshift_r(lo, hi, 2 * (c0 & 3)), vg, vm);
    int8_t* pg = gz + o + c0;
    int8_t* pm = m + o + c0;
    if (c0 >= 0 && c0 + 16 <= n) {
      store16(pg, vg);
      store16(pm, vm);
    } else {
      store_bytes(pg, vg, -c0, n - c0);
      store_bytes(pm, vm, -c0, n - c0);
    }
  }
}

}  // namespace

HAIL_API int hail_unpack_gt_2bit(const void* u8, long long R, int n4, int n,
                                 void* gz, void* m, void* stream) {
  if (R <= 0 || n <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)gz & 15) || ((uintptr_t)m & 15))
    return (int)cudaErrorMisalignedAddress;
  const bool flat = (n & 3) == 0 && ((uintptr_t)u8 & 3) == 0;
  dim3 grid;
  if (flat) {
    const long long words = (R * (long long)n4 + 3) / 4;   // the tail's too
    grid = dim3((unsigned)((words + kThreads * kPer - 1) / (kThreads * kPer)));
  } else {
    const int pieces = (n + 15) / 16 + 1;   // a row may straddle one more
    grid = dim3((unsigned)((pieces + kThreads - 1) / kThreads),
                (unsigned)(R < 32768 ? R : 32768));
  }
  unpack_gt_2bit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)u8, R, n4, n, (int8_t*)gz, (int8_t*)m, flat ? 1 : 0);
  return (int)cudaGetLastError();
}
