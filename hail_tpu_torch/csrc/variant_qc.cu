// K5: every per-variant QC counter of a block of packed calls, in one pass.
//
// Replaces hail_tpu/ops/qc.py:22 `variant_qc_block` (XLA-compiled in the
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
// before they are added (no FMA). While every partial sum of squares stays
// below 2^53, that is C * max(DP)^2 < 2^53 (and the same for GQ), every
// partial sum is an exact integer, so the result is bit-equal in any order
// of addition, atomics across segments included.
//
// Bound on the H100: device memory. A row of C entries is read once, 13 B
// per entry with DP and GQ (4 packed, 1 missing, 4 + 4), and the outputs
// are 8 int32 counts, 8 f64 statistics and 2A int32 allele counts per row:
// 2,048 x 10,000 is 266.5 MB, 0.0795 ms at 3.35 TB/s; 256 x 100,000 is
// 332.8 MB, 0.0993 ms.
//
// Design. The first design (one 256-thread block per row, 4-byte
// loads, the reference's formulas per entry) ran at about a quarter of that
// bound. What held it, and what this one does:
// 1. Serialised, narrow loads: the packed load waited on a 1-byte load of
//    the mask and a branch, so a thread had about one load of each input
//    in flight. Here a lane takes 8 entries a step, two groups of 4
//    consecutive entries 128 entries apart: two int4 of calls, two 4-byte
//    words of the mask, two int4 each of DP and GQ (104 B, 3.3 KB a warp,
//    each load instruction of the warp 512 contiguous bytes, 128 of the
//    mask). All are issued before any is used, and the mask is folded in
//    arithmetically (__vcmpne4): no load waits on another and no branch
//    depends on the data. Groups past the segment's end are predicated
//    off and read as missing. Every load is a streaming one (__ldcs,
//    evict first): each byte is read once.
// 2. Instruction issue: the reference's formulas spend a compare and an
//    add or two on each of 13 counters per call, and with the loads fixed
//    they still held the kernel well short of a stream of its bytes (an
//    exploratory build of this kernel with them, timed on the card beside
//    the table). Here a call costs one lookup: its ploidy, min(j, 3),
//    min(k, 3), j == k and the mask bit index a 256-entry table in shared
//    memory (built by the block at start, 4 KB) whose entry holds every
//    counter's increment byte-packed in three words; a lane adds the words
//    for the 8 entries of a step and unpacks them once a step. DP and GQ
//    stay f64: max(v, 0) converted, added, squared and added, the count by
//    a compare, min and max by integer min / max (the min as unsigned, so
//    the -1 of a missing value never wins).
// 3. One block per row with a per-row block tail (histogram zeroing, three
//    __syncthreads, thread 0 summing eight warps): here a warp owns one
//    segment of one row, reduces it by shuffles only and adds it into the
//    zeroed outputs with global atomics (red.global: int32 adds; f64 adds,
//    exact in the range above, so independent of order; min and max as
//    atomicMin / atomicMax on the f64's bits, which order like the values
//    since DP and GQ are >= 0, into slots the wrapper fills with +inf and
//    -inf, so a row with no defined value keeps them). One launch per call.
// 4. Wave quantisation and idle SMs at few, wide rows (256 rows were 256
//    blocks on 132 SMs): the wrapper's `_launch_plan` (ops/qc.py) cuts rows
//    into segments (a multiple of 16 entries, at least 2,048 unless the row
//    is shorter) in the number that best fills the rounds of the 16 warps
//    a SM holds (two blocks of 8 warps; the launch bounds keep the build
//    to 128 registers). 2,048 x 10,000 runs one warp a row (2,048 warps,
//    0.97 of a round on 132 SMs), 256 x 100,000 runs 33 segments a row
//    (8,448 warps, four full rounds).
// 5. Alleles 2..A-1 through a shared-memory histogram in the per-entry
//    loop (opt-in shared memory above 6,144 alleles): here alleles 0, 1
//    and 2 count in the table (every call of a biallelic or triallelic
//    call set); the table flags a call with an allele >= 3 that counts, and
//    only where A > 3 and some lane of the warp flagged one does the step
//    take a second pass over its entries in registers, adding each allele
//    in 3..A-1 with one global atomic per distinct allele of the warp
//    (__match_any_sync). Nothing else depends on A.
// Alignment: a group of 4 needs the calls, DP and GQ at 16-byte and the
// mask at 4-byte boundaries. A segment takes a head of up to 3 entries to
// the first such entry and a tail of up to 3 after its last whole group,
// both in one scalar pass of the warp. Where the inputs' phases differ
// (data_ptr / 4 of an int32 input and data_ptr of the mask not equal
// modulo 4), no entry is aligned for all; the launch then takes the same
// kernel's scalar loop, four 4-byte entries a lane a step, loads first.
//
// Build (nvcc -Xptxas -v for sm_90a, nvcc.log of the H100 run): 123
// registers a thread with DP and GQ, 113 with one of them, 95 with
// neither; no spills, no stack, 4 KB of static shared memory (the table).

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kG = 2;   // groups of 4 entries a lane takes a step
static_assert(kThreads == 256,
              "a block builds the 256-entry table, one entry a thread");

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// DP or GQ: the defined values (>= 0) of one lane's entries
struct FieldAcc {
  double sum = 0.0, sumsq = 0.0;
  int n = 0, mx = -1;
  unsigned mn = 0xffffffffu;   // as unsigned, a negative never wins

  __device__ __forceinline__ void add(int v) {
    const double d = (double)max(v, 0);   // + 0.0 leaves a sum as it is
    sum = __dadd_rn(sum, d);
    sumsq = __dadd_rn(sumsq, __dmul_rn(d, d));
    n += v >= 0;
    mn = min(mn, (unsigned)v);
    mx = max(mx, v);                      // a negative never beats -1
  }

  __device__ __forceinline__ void add4(int4 v) {
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
};

// The increments of one entry, byte-packed, by
//   idx = ploidy | min(j, 3) << 2 | min(k, 3) << 4 | (j == k) << 6
//         | missing << 7:
//   x: n_called, AN, n_het, n_hom_ref_diploid
//   y: n_hom_var_diploid, n_non_ref, AC of allele 0, of allele 1
//   z: AC of allele 2, homozygotes of 1, of 2, "an allele >= 3 counts"
// (j == k is given apart, since min(j, 3) == min(k, 3) == 3 does not say)
__device__ uint4 table_entry(int idx) {
  if (idx & 128) return make_uint4(0u, 0u, 0u, 0u);   // missing
  const int ploidy = idx & 3, jc = (idx >> 2) & 3, kc = (idx >> 4) & 3;
  const bool eq = (idx >> 6) & 1;
  const bool hap = ploidy >= 1, dip = ploidy == 2, homz = dip && eq;
  const unsigned x = 1u | (unsigned)ploidy << 8 | (unsigned)(dip && !eq) << 16 |
                     (unsigned)(homz && jc == 0) << 24;
  const unsigned y = (unsigned)(homz && jc > 0) |
                     (unsigned)(jc > 0 || (dip && kc > 0)) << 8 |
                     (unsigned)((hap && jc == 0) + (dip && kc == 0)) << 16 |
                     (unsigned)((hap && jc == 1) + (dip && kc == 1)) << 24;
  const unsigned z = (unsigned)((hap && jc == 2) + (dip && kc == 2)) |
                     (unsigned)(homz && jc == 1) << 8 |
                     (unsigned)(homz && jc == 2) << 16 |
                     (unsigned)((hap && jc == 3) || (dip && kc == 3)) << 24;
  return make_uint4(x, y, z, 0u);
}

// the call counters of one lane's entries: a step's increments summed
// byte-packed (a step is at most 8 entries, so no byte passes 24), then
// unpacked
struct CallAcc {
  unsigned sx = 0, sy = 0, sz = 0;
  int called = 0, an = 0, het = 0, hrd = 0, hvd = 0, non_ref = 0;
  int ac0 = 0, ac1 = 0, ac2 = 0, hom1 = 0, hom2 = 0;

  // `miss` is 0, or 128 where the entry is missing
  __device__ __forceinline__ void add(const uint4* tab, int p, unsigned miss) {
    const int j = (p >> 3) & 0x3FFF;
    const int k = (p >> 17) & 0x7FFF;
    const unsigned idx = (unsigned)(p & 3) | (unsigned)min(j, 3) << 2 |
                         (unsigned)min(k, 3) << 4 | (unsigned)(j == k) << 6 |
                         miss;
    const uint4 t = tab[idx];
    sx += t.x;
    sy += t.y;
    sz += t.z;
  }

  // ends a step: true where one of its entries has an allele >= 3 to count
  __device__ __forceinline__ bool flush() {
    called += sx & 0xFF;
    an += (sx >> 8) & 0xFF;
    het += (sx >> 16) & 0xFF;
    hrd += sx >> 24;
    hvd += sy & 0xFF;
    non_ref += (sy >> 8) & 0xFF;
    ac0 += (sy >> 16) & 0xFF;
    ac1 += sy >> 24;
    ac2 += sz & 0xFF;
    hom1 += (sz >> 8) & 0xFF;
    hom2 += (sz >> 16) & 0xFF;
    const bool rare = (sz >> 24) != 0;
    sx = sy = sz = 0;
    return rare;
  }
};

// `row[a] += 1` for each lane where `on`, one atomic per distinct `a` of the
// warp. Every lane of the warp calls it.
__device__ __forceinline__ void rare_add(int* row, int a, bool on, int lane) {
  const unsigned act = __ballot_sync(kFull, on);
  if (act == 0u) return;
  if (on) {
    const unsigned peers = __match_any_sync(act, a);
    if (lane == __ffs(peers) - 1) atomicAdd(row + a, __popc(peers));
  }
}

// the alleles in 3..A-1 of one entry, in AC and homozygote_count
__device__ __forceinline__ void rare_entry(int* ac_row, int* hom_row, int p,
                                           bool miss, int A, int lane) {
  const int ploidy = p & 3;
  const int j = (p >> 3) & 0x3FFF;
  const int k = (p >> 17) & 0x7FFF;
  const bool hap = !miss && ploidy >= 1;
  const bool dip = !miss && ploidy == 2;
  const bool jr = j >= 3 && j < A;
  rare_add(ac_row, j, hap && jr, lane);
  rare_add(ac_row, k, dip && k >= 3 && k < A, lane);
  rare_add(hom_row, j, dip && j == k && jr, lane);
}

__device__ __forceinline__ void red_add(int* p, int v) {
  if (v) atomicAdd(p, v);
}

// a field's segment totals into its row: count, sums, min, max
__device__ __forceinline__ void flush_field(FieldAcc f, int* count,
                                            double* st, long long R) {
  const int n = warp_sum(f.n);
  const unsigned mn = (unsigned)warp_min((int)min(f.mn, 0x7fffffffu));
  const int mx = warp_max(f.mx);
  const double sum = warp_sum_f64(f.sum), sumsq = warp_sum_f64(f.sumsq);
  if ((threadIdx.x & 31) != 0 || n == 0) return;
  atomicAdd(count, n);
  atomicAdd(st, sum);
  atomicAdd(st + R, sumsq);
  atomicMin(reinterpret_cast<long long*>(st + 2 * R),
            __double_as_longlong((double)mn));
  atomicMax(reinterpret_cast<long long*>(st + 3 * R),
            __double_as_longlong((double)mx));
}

// Two blocks a SM: ops/qc._RESIDENT_WARPS_PER_SM plans on 2 x kWarps resident
// warps (tests/test_torch_qc_plan.py holds the two to each other).
template <bool kDp, bool kGq>
__global__ void __launch_bounds__(kThreads, 2)
variant_qc_kernel(const int* __restrict__ packed,
                  const uint8_t* __restrict__ missing,
                  const int* __restrict__ dp, const int* __restrict__ gq,
                  long long R, int C, int A, int seg_len, int n_segs,
                  bool vec, int* __restrict__ counts, int* __restrict__ ac,
                  int* __restrict__ hom, double* __restrict__ stats) {
  __shared__ uint4 s_tab[256];
  s_tab[threadIdx.x] = table_entry(threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // warp w takes segment w % n_segs of row w / n_segs (ops/qc._launch_plan)
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= R * n_segs) return;
  const long long r = w / n_segs;
  const long long c0 = (w % n_segs) * (long long)seg_len;
  const long long c1 = min((long long)C, c0 + seg_len);
  const long long e0 = r * C + c0, e1 = r * C + c1;   // flat entries
  int* ac_row = ac + r * A;
  int* hom_row = hom + r * A;
  const bool rare_alleles = A > 3;
  CallAcc cnt;
  FieldAcc fdp, fgq;

  // entries b + 32q + lane below `end`, four a lane, loads first (b and
  // end may differ between lanes)
  auto scalar4 = [&](long long b, long long end) {
    int p[4], d[4], g[4];
    unsigned m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long e = b + 32 * q + lane;
      const bool on = e < end;
      p[q] = on ? __ldcs(packed + e) : 0;
      m[q] = !on || __ldcs(missing + e) != 0 ? 128u : 0u;
      d[q] = kDp && on ? __ldcs(dp + e) : -1;
      g[q] = kGq && on ? __ldcs(gq + e) : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cnt.add(s_tab, p[q], m[q]);
      if (kDp) fdp.add(d[q]);
      if (kGq) fgq.add(g[q]);
    }
    const bool rare = cnt.flush();
    if (rare_alleles && __any_sync(kFull, rare)) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rare_entry(ac_row, hom_row, p[q], m[q] != 0, A, lane);
    }
  };

  if (!vec) {
    for (long long b = e0; b < e1; b += 128) scalar4(b, e1);
  } else {
    // head: up to 3 entries to the mask's first 4-byte boundary; then
    // n_grp whole groups of 4 from ea; tail: up to 3 entries from eb. The
    // head and the tail are one masked scalar pass (lanes 0-3, 4-7).
    const int h = (int)((0u - (unsigned)(uintptr_t)(missing + e0)) & 3u);
    const long long ea = min(e1, e0 + h);
    const long long n_grp = (e1 - ea) >> 2;
    const long long eb = ea + 4 * n_grp;
    if (ea > e0 || e1 > eb) {
      const long long b = lane < 4 ? e0 : eb - 4;
      scalar4(b, lane < 4 ? ea : (lane < 8 ? e1 : b));
    }
    const int4* p4 = reinterpret_cast<const int4*>(packed + ea);
    const unsigned* m4 = reinterpret_cast<const unsigned*>(missing + ea);
    const int4* d4 = kDp ? reinterpret_cast<const int4*>(dp + ea) : nullptr;
    const int4* g4 = kGq ? reinterpret_cast<const int4*>(gq + ea) : nullptr;
    const int4 none = make_int4(-1, -1, -1, -1);
    // a step: kG groups of 4 entries a lane, 32 groups apart, loads first
    for (long long s = 0; s < n_grp; s += 32 * kG) {
      int4 pv[kG], dv[kG], gv[kG];
      unsigned mv[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const long long g = s + 32 * q + lane;
        const bool on = g < n_grp;
        pv[q] = on ? __ldcs(p4 + g) : make_int4(0, 0, 0, 0);
        mv[q] = on ? __ldcs(m4 + g) : 0x01010101u;   // past the end: missing
        if (kDp) dv[q] = on ? __ldcs(d4 + g) : none;
        if (kGq) gv[q] = on ? __ldcs(g4 + g) : none;
      }
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        // 128 where the mask's byte is not 0
        const unsigned nz = __vcmpne4(mv[q], 0u) & 0x80808080u;
        cnt.add(s_tab, pv[q].x, nz & 0xFFu);
        cnt.add(s_tab, pv[q].y, (nz >> 8) & 0xFFu);
        cnt.add(s_tab, pv[q].z, (nz >> 16) & 0xFFu);
        cnt.add(s_tab, pv[q].w, nz >> 24);
        if (kDp) fdp.add4(dv[q]);
        if (kGq) fgq.add4(gv[q]);
      }
      const bool rare = cnt.flush();
      if (rare_alleles && __any_sync(kFull, rare)) {
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          const unsigned m = mv[q];
          rare_entry(ac_row, hom_row, pv[q].x, (m & 0xFFu) != 0u, A, lane);
          rare_entry(ac_row, hom_row, pv[q].y, (m & 0xFF00u) != 0u, A, lane);
          rare_entry(ac_row, hom_row, pv[q].z, (m & 0xFF0000u) != 0u, A,
                     lane);
          rare_entry(ac_row, hom_row, pv[q].w, (m & 0xFF000000u) != 0u, A,
                     lane);
        }
      }
    }
  }

  // the segment's totals by shuffles, then one atomic per non-zero output
  const int called = warp_sum(cnt.called), het = warp_sum(cnt.het);
  const int hrd = warp_sum(cnt.hrd), hvd = warp_sum(cnt.hvd);
  const int non_ref = warp_sum(cnt.non_ref), an = warp_sum(cnt.an);
  const int ac0 = warp_sum(cnt.ac0), ac1 = warp_sum(cnt.ac1);
  const int ac2 = warp_sum(cnt.ac2), hom1 = warp_sum(cnt.hom1);
  const int hom2 = warp_sum(cnt.hom2);
  if (kDp) flush_field(fdp, counts + 6 * R + r, stats + r, R);
  if (kGq) flush_field(fgq, counts + 7 * R + r, stats + 4 * R + r, R);
  if (lane != 0) return;
  red_add(counts + 0 * R + r, called);
  red_add(counts + 1 * R + r, het);
  red_add(counts + 2 * R + r, hrd);
  red_add(counts + 3 * R + r, hvd);
  red_add(counts + 4 * R + r, non_ref);
  red_add(counts + 5 * R + r, an);
  if (A > 0) {
    red_add(ac_row, ac0);
    red_add(hom_row, hrd);
  }
  if (A > 1) {
    red_add(ac_row + 1, ac1);
    red_add(hom_row + 1, hom1);
  }
  if (A > 2) {
    red_add(ac_row + 2, ac2);
    red_add(hom_row + 2, hom2);
  }
}

// the vector body needs, for the same entries, the int32 inputs at 16-byte
// and the mask at 4-byte boundaries: p / 4 and the mask's address equal
// modulo 4
bool same_phase(const void* p, const void* mask) {
  const uintptr_t a = (uintptr_t)p, m = (uintptr_t)mask;
  return (a & 3) == 0 && (((a >> 2) - m) & 3) == 0;
}

template <bool kDp, bool kGq>
void launch(unsigned blocks, cudaStream_t stream, const void* packed,
            const void* missing, const void* dp, const void* gq, long long R,
            int C, int A, int seg_len, int n_segs, bool vec, void* counts,
            void* ac, void* hom, void* stats) {
  variant_qc_kernel<kDp, kGq><<<blocks, kThreads, 0, stream>>>(
      (const int*)packed, (const uint8_t*)missing, (const int*)dp,
      (const int*)gq, R, C, A, seg_len, n_segs, vec, (int*)counts, (int*)ac,
      (int*)hom, (double*)stats);
}

}  // namespace

// `fields`: bit 0 set when DP is given, bit 1 when GQ is (a pointer cannot
// say so: an empty tensor's may be null). `seg_len`, `n_segs`: the plan of
// ops/qc._launch_plan. The outputs arrive zeroed, and stats' min and max
// rows filled with +inf and -inf.
HAIL_API int hail_variant_qc(const void* packed, const void* missing,
                             const void* dp, const void* gq, long long R,
                             int C, int A, int fields, int seg_len,
                             int n_segs, void* counts, void* ac, void* hom,
                             void* stats, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (C < 0 || A < 0 || seg_len <= 0 || n_segs <= 0 ||
      (long long)seg_len * n_segs < C)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (R * n_segs + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool has_dp = (fields & 1) != 0, has_gq = (fields & 2) != 0;
  const bool vec = same_phase(packed, missing) &&
                   (!has_dp || same_phase(dp, missing)) &&
                   (!has_gq || same_phase(gq, missing));
  auto* fn = has_dp ? (has_gq ? launch<true, true> : launch<true, false>)
                    : (has_gq ? launch<false, true> : launch<false, false>);
  fn((unsigned)blocks, (cudaStream_t)stream, packed, missing, dp, gq, R, C,
     A, seg_len, n_segs, vec, counts, ac, hom, stats);
  return (int)cudaGetLastError();
}
