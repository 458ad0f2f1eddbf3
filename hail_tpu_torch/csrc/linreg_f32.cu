// K1: the f32 one-pass linreg sums, one read of int8 G.
//
// Replaces the Pallas kernel hail_tpu/ops/linreg_i8.py `_kernel` (launched
// at :103 by `_pallas_sums_call`). From G int8 (R, N), -1 = missing, and
// W f32 (N, KP) = [Q | Ys] it computes in one pass over G
//   GW = Gz · W, MW = M · W        f32 (R, KP), Gz = max(G, 0), M = [G < 0]
//   ST = [ΣM, ΣGz, ΣGz²]            f32 (R, 3)
// with plain f32 FMAs on the CUDA cores: the reference asks for true-f32
// products (Precision.HIGHEST), so no TF32 and no tensor cores, whose f32
// accumulation truncates. g·w is exact for g in {0, 1, 2}; only the order
// of the sums differs from the plain torch version. The row sums are taken
// as integers (dp4a) per lane and added across lanes as floats: equal to
// the plain version's f32 sums while those are exact, below 2²⁴, which the
// caller checks (`_MAX_F32_N`). The kernel takes W transposed and
// zero-padded, WT (KP, ldw) with ldw a multiple of 4 >= N and a 16-byte
// aligned base (ops/linreg_i8.f32_operand builds it once per call), so that
// four consecutive samples of one column are one 16-byte piece.
//
// Bound on the H100 at 8,192 x 10,000, KP = 5: bytes, by a hair. The 82 MB
// of G, W and the outputs are 0.0246 ms of device memory at 3.35 TB/s; the
// f32 work the function needs, 2·KP = 10 multiply-adds per entry (the three
// row sums are integer sums of small bytes, far below any rate), is 1.64
// TFLOP, 0.0245 ms at 67 TFLOP/s. What holds the kernel is the second: an
// SM's scheduler issues one warp instruction a cycle and one FFMA a cycle
// saturates its f32 lanes, so every other instruction costs an FFMA, and
// the design counts instructions (bench/sass_count.py: 14.4 per entry in
// the tile's straight-line body, 10 of them FFMAs, so at most 10 / 14.4 of
// the f32 rate).
//
// Design.
//   - Columns are a template parameter, CB = 1..8: no zero column is read
//     or multiplied. KP > 8 takes further chunks of <= 8 columns, each its
//     own launch that reads G again: at KP = 13 the second chunk adds the
//     whole 82 MB stream and its conversions for five more columns, and
//     the call takes about two and a half times as long as at KP = 5.
//   - A warp carries RW rows (4; 2 where CB >= 7 would spill): a lane takes
//     four consecutive samples, reads their CB float4 of W from shared
//     memory once and applies them to all RW rows, one LDS.128 per 8·RW
//     FFMAs. A lane keeps RW·2·CB f32 sums and RW·3 integer sums in
//     registers (128 in all, the launch bound); warp shuffles reduce them
//     at the end.
//   - A block is 16 warps, 64 rows, one block per SM: 8,192 rows are 128
//     blocks for 132 SMs, one wave. W is staged in tiles of kTN samples,
//     double-buffered with 16-byte cp.async: the copy of tile t + 1 is
//     issued right after the one barrier of tile t and runs under its
//     arithmetic.
//   - G goes straight to registers, a 32-bit word (four samples) per row
//     and step, loaded kPF steps before it is used.
//   - A tile from which every load lies inside the row runs as
//     straight-line code with no check in it (the compiler then overlaps
//     one step's loads and conversions with another's FFMAs); only the
//     row's last tiles check each step.
//   - Conversion is packed, four entries a word: PRMT replicates each
//     byte's sign into a mask, gz = w & ~mask, m = mask & 0x01010101, three
//     dp4a take the row sums. A gz byte becomes a float by the conversion
//     instruction with a byte selector; a missing flag becomes 2.0f by one
//     PRMT of mask & 0x40404040 into a float's top byte, so MW is summed
//     doubled and halved once at the end, which changes nothing but a
//     result below 2⁻¹²⁵.
//   - Rows whose G is not 4-byte aligned (N % 4 != 0 or an offset base) load
//     their words byte by byte (`load4`) in an instantiation of their own.

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;               // a block; one block per SM
constexpr int kThreads = kWarps * 32;
constexpr int kTN = 1024;                // samples per staged tile of W
constexpr int kJ = kTN / 128;            // 4-sample words per lane and tile
constexpr int kPF = 2;                   // steps G is loaded ahead of use
constexpr int kMaxCB = 8;                // columns of WT per launch
static_assert(kJ % kPF == 0, "the ring of G words turns whole times a tile");
static_assert(kTN % 128 == 0, "a warp step covers 128 samples");
static_assert(kThreads % (kTN / 4) == 0, "a block copies whole tile columns");

// byte Q of `w` as a float: one conversion with a byte selector
template <int Q>
__device__ __forceinline__ float byte_float(unsigned w) {
  return (float)((w >> (8 * Q)) & 0xFFu);
}

template <int CB, int RW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 1)
linreg_i8_sums_kernel(const int8_t* __restrict__ G,
                      const float* __restrict__ WT, int ldw, int R, int N,
                      int KP, int c0, float* __restrict__ GW,
                      float* __restrict__ MW, float* __restrict__ ST) {
  extern __shared__ __align__(16) float Ws[];   // two tiles of CB x kTN
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * RW;
  const int n_tiles = (N + kTN - 1) / kTN;

  // the lane's four samples of step 0 in each of the warp's rows; the
  // pointers move on by a tile at a time
  const int8_t* g_ptr[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long long r = row0 + i < R ? row0 + i : R - 1;
    g_ptr[i] = G + r * (long long)N + 4 * lane;
  }

  // this thread's 16-byte pieces of a W tile: samples w_off.. of columns
  // w_col, w_col + kPass, ...; the source moves on by a tile at a time
  constexpr int kPass = kThreads / (kTN / 4);   // columns the block covers
  const int w_col = threadIdx.x / (kTN / 4);
  const int w_off = 4 * (threadIdx.x % (kTN / 4));
  const float* w_src = WT + (long long)(c0 + w_col) * ldw + w_off;
  int w_left = ldw - w_off;                     // samples of WT from w_src
  auto stage = [&](int t) {
    float* dst = Ws + (t & 1) * (CB * kTN) + w_col * kTN + w_off;
    const bool ok = w_left > 0;
#pragma unroll
    for (int p = 0; p * kPass < CB; ++p)
      if (w_col + p * kPass < CB)
        cp_async16(dst + p * kPass * kTN,
                   ok ? w_src + (long long)p * kPass * ldw : WT, ok ? 16 : 0);
    w_src += kTN;
    w_left -= kTN;
  };
  // the words of the step `ahead` steps after the tile at g_ptr: `left`
  // samples of the row remain from the tile's first. A step that lies
  // wholly inside the row (the same for the whole warp) loads unpredicated.
  auto load_step = [&](int (&g)[RW], int ahead, int left, bool safe) {
    const int off = 128 * ahead;
    if (ALIGNED && (safe || left >= off + 128)) {
#pragma unroll
      for (int i = 0; i < RW; ++i)
        g[i] = *reinterpret_cast<const int*>(g_ptr[i] + off);
    } else {
      const int mine = left - off - 4 * lane;
#pragma unroll
      for (int i = 0; i < RW; ++i)
        g[i] = mine > 0 ? load4(g_ptr[i] + off, mine, ALIGNED) : 0;
    }
  };

  float acc_g[RW][CB];
  float acc_m[RW][CB];
  int n_miss[RW], sum_g[RW], sum_gg[RW];
  int g4[kPF][RW];   // a ring: step s of the row lives in g4[s % kPF]
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    n_miss[i] = sum_g[i] = sum_gg[i] = 0;
#pragma unroll
    for (int c = 0; c < CB; ++c) acc_g[i][c] = acc_m[i][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPF; ++j) load_step(g4[j], j, N, false);
  stage(0);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // this thread's pieces of tile t have landed
    __syncthreads();      // ... everyone's, and tile t - 1 is no longer read
    if (t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    const float* tile = Ws + (t & 1) * (CB * kTN) + 4 * lane;
    const int left = N - t * kTN;
    // The steps of a tile. A tile from which every load of its steps,
    // those kPF steps ahead too, lies inside the row is straight-line code
    // with no check in it, so that the compiler overlaps one step's loads
    // and conversions with the previous step's FFMAs; the row's last tiles
    // check each step.
    auto steps = [&](auto safe) {
      constexpr bool kSafe = decltype(safe)::value;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        constexpr int kRing = kPF;            // step j lives in g4[j % kPF]
        if (kSafe || 128 * j < left) {        // the same for the whole warp
          float4 w[CB];
#pragma unroll
          for (int c = 0; c < CB; ++c)
            w[c] = *reinterpret_cast<const float4*>(tile + c * kTN + 128 * j);
          unsigned words[RW];
#pragma unroll
          for (int i = 0; i < RW; ++i) words[i] = (unsigned)g4[j % kRing][i];
          load_step(g4[j % kRing], j + kPF, left, kSafe);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const unsigned mask = prmt(words[i], 0, 0xBA98);   // each byte's sign
            const unsigned gz4 = words[i] & ~mask;
            const unsigned m4 = mask & 0x01010101u;
            n_miss[i] = __dp4a((int)m4, 0x01010101, n_miss[i]);
            sum_g[i] = __dp4a((int)gz4, 0x01010101, sum_g[i]);
            sum_gg[i] = __dp4a((int)gz4, (int)gz4, sum_gg[i]);
            const float gz[4] = {byte_float<0>(gz4), byte_float<1>(gz4),
                                 byte_float<2>(gz4), byte_float<3>(gz4)};
            // 2.0f where missing (0x40 into a float's top byte): MW doubled
            const unsigned m2 = mask & 0x40404040u;
            const float mf[4] = {__uint_as_float(prmt(m2, 0, 0x0444)),
                                 __uint_as_float(prmt(m2, 0, 0x1444)),
                                 __uint_as_float(prmt(m2, 0, 0x2444)),
                                 __uint_as_float(prmt(m2, 0, 0x3444))};
#pragma unroll
            for (int c = 0; c < CB; ++c) {
              acc_g[i][c] = fmaf(gz[0], w[c].x, acc_g[i][c]);
              acc_g[i][c] = fmaf(gz[1], w[c].y, acc_g[i][c]);
              acc_g[i][c] = fmaf(gz[2], w[c].z, acc_g[i][c]);
              acc_g[i][c] = fmaf(gz[3], w[c].w, acc_g[i][c]);
              acc_m[i][c] = fmaf(mf[0], w[c].x, acc_m[i][c]);
              acc_m[i][c] = fmaf(mf[1], w[c].y, acc_m[i][c]);
              acc_m[i][c] = fmaf(mf[2], w[c].z, acc_m[i][c]);
              acc_m[i][c] = fmaf(mf[3], w[c].w, acc_m[i][c]);
            }
          }
        }
      }
    };
    if (ALIGNED && left >= kTN + 128 * kPF)
      steps(std::integral_constant<bool, true>{});
    else
      steps(std::integral_constant<bool, false>{});
#pragma unroll
    for (int i = 0; i < RW; ++i) g_ptr[i] += kTN;
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long long row = row0 + i;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float vg = warp_sum(acc_g[i][c]);
      const float vm = 0.5f * warp_sum(acc_m[i][c]);   // summed doubled
      if (lane == 0 && row < R) {
        GW[row * KP + c0 + c] = vg;
        MW[row * KP + c0 + c] = vm;
      }
    }
    if (c0 == 0) {
      // a lane's integer sums cannot overflow (N / 32 · 127² < 2³¹ below
      // `_MAX_F32_N`); across lanes they are added as floats, exact below 2²⁴
      const float nm = warp_sum((float)n_miss[i]);
      const float sg = warp_sum((float)sum_g[i]);
      const float sgg = warp_sum((float)sum_gg[i]);
      if (lane == 0 && row < R) {
        ST[row * 3] = nm;
        ST[row * 3 + 1] = sg;
        ST[row * 3 + 2] = sgg;
      }
    }
  }
}

template <int CB>
int launch_chunk(const void* G, const void* WT, int ldw, int R, int N, int KP,
                 int c0, void* GW, void* MW, void* ST, cudaStream_t stream) {
  // 2·CB·RW sums, 3·RW counts, kPF·RW words of G and CB float4 of W per
  // lane must fit the 128 registers of 512 threads per SM
  constexpr int RW = CB <= 6 ? 4 : 2;
  constexpr int smem_bytes = 2 * CB * kTN * (int)sizeof(float);
  const bool aligned = (N & 3) == 0 && ((uintptr_t)G & 3) == 0;
  auto kernel = aligned ? linreg_i8_sums_kernel<CB, RW, true>
                        : linreg_i8_sums_kernel<CB, RW, false>;
  // per instantiation, set once; callers may launch from several threads
  static std::atomic<bool> sized[2];
  if (!sized[aligned].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    sized[aligned].store(true, std::memory_order_release);
  }
  const int rows = kWarps * RW;
  const unsigned blocks = (unsigned)((R + rows - 1) / rows);
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(
      (const int8_t*)G, (const float*)WT, ldw, R, N, KP, c0, (float*)GW,
      (float*)MW, (float*)ST);
  return (int)cudaGetLastError();
}

}  // namespace

// WT (KP, ldw) as ops/linreg_i8.f32_operand lays it out: 16-byte aligned,
// ldw a multiple of 4 >= N, zeros past column N
HAIL_API int hail_linreg_i8_sums(const void* G, const void* WT, int ldw,
                                 int R, int N, int KP, void* GW, void* MW,
                                 void* ST, void* stream) {
  if (R <= 0 || KP <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)WT & 15) || (ldw & 3) || ldw < N)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < KP; c0 += kMaxCB) {
    int err = 0;
    switch (KP - c0 < kMaxCB ? KP - c0 : kMaxCB) {
      case 1: err = launch_chunk<1>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 2: err = launch_chunk<2>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 3: err = launch_chunk<3>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 4: err = launch_chunk<4>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 5: err = launch_chunk<5>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 6: err = launch_chunk<6>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      case 7: err = launch_chunk<7>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s); break;
      default: err = launch_chunk<8>(G, WT, ldw, R, N, KP, c0, GW, MW, ST, s);
    }
    if (err) return err;
  }
  return 0;
}
