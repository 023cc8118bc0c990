// The Layer III rate loop's bit evaluation (bits_at) and its stepsize
// searches (K3, search_kernel), for Hopper.
//
// bits_at replaces, on the rate loop's path, the Pallas TPU kernel
// mp3tpu/ops/pallas_bits.py:_kernel (K1; its first port is csrc/hist_c1.cu)
// together with the chain around it in mp3tpu/ops/jaxloop.py:_bits_at:
// quantize_pow75, calc_runlen, subdivide, count_all and _choose_tables.
// For a batch of granules in traversal order (short granules permuted
// sfb -> window -> line), |xr|^0.75 and one stepsize factor per granule, it
// returns exactly
//   bits (float32, 1e9 where ix_max > IXMAX), count1, big_values, r0, r1,
//   a1, a2, table_select[3], count1table_select, ix_max,
// the values of mp3tpu_torch/ops/bits_at.py:bits_at_plain, its oracle.
//
// What bounds it on an H100: a granule reads 2,304 bytes of |xr|^0.75 and
// 6 bytes of per-granule scalars and writes 48 bytes; its work is a few
// hundred integer operations.  At G = 4096 that is ~9.7 MB, ~2.9 us at
// 3.35 TB/s, against ~0.6 us of instructions at the card's integer
// rate: bytes.
// Measured on an H100 80GB HBM3 at 700 W it takes ~11.6 us at G = 4096
// (a quarter of that bound) and ~8.8 us at G = 512: at these widths one
// wave holds one granule per warp, so the granule's chain of dependent
// warp reductions and shared loads, and ~1,500 warp instructions per
// granule, set the time.  At G = 65536 it reaches ~40% of the bound.
//
// Design (what K1 spent its time on, and what this kernel does instead):
//  - K1 contracted a 3 x 256 class histogram with all 32 tables in shared
//    memory.  new_choose_table needs at most three tables per region: the
//    first table for the region's max and its alternates, or the two ESC
//    tables.  Once the region maxima are known, each pair adds its cost
//    under its own region's candidates, read from the LUT in shared memory:
//    three byte loads per pair, no histogram, no atomics.  The LUT has 33
//    rows of 260 bytes: the 32 tables and a zero row for unused candidates;
//    the 4-byte pad puts one class of neighbouring tables in different banks.
//  - K1 staged the 8 KB LUT once per granule; here a CTA of 16 warps stages
//    it once and its warps walk over granules (one warp per granule).
//  - Each lane loads its granule's |xr|^0.75 as 16-byte coalesced loads and
//    quantizes in registers; the quantized values never reach device memory.
//    Quantization rounds as eager PyTorch does (multiply, subtract, add, each
//    rounded to nearest, no FMA contraction), so the integers are torch's.
//  - Run lengths, ix_max, region maxima and the sums are warp reductions
//    (redux.sync); subdivide runs on lanes 0..22 against the sfb table.
//    Per-lane sums (<= 10 pairs x 36 bits < 2^10) are packed three regions
//    to a word before they are reduced.
//  - count1 quads come from 4-bit nibbles, one per float4; a misaligned
//    region (the roll by -2 lines) takes the next float4's nibble through a
//    shuffle.  The wrap from the last float4 to the first mirrors the roll,
//    but a misaligned count1 region ends by line 571 and never reaches it.
//
// K3 (search_kernel) replaces the JAX package's stepsize searches, device
// loops in XLA (mp3tpu/ops/jaxloop.py:528-613: search_walk and
// search_stepsize, with the _bits_at evaluation each step calls).  Per
// granule it returns what mp3tpu_torch/ops/loop.py's lockstep plain
// versions return: search_stepsize_plain (an 8-step bisection of the
// stepsize on [max(qanf, QMIN, qss_lo), QMAX], a walk up while over
// budget, at most 40 steps, and 3 downward steps that keep a finer
// stepsize that still fits, then the counts at the result) or
// search_walk_plain (the walk up from a warm start).  The plain versions
// step the whole batch until its slowest granule fits, but each granule's
// update is masked and depends on that granule alone, so each granule's
// own search with the same caps gives the same stepsizes, bits and counts.
//  - What bounds it on an H100: per granule 2,304 bytes in, ~20 bytes of
//    scalars and 64 bytes of rows out (~9.8 MB at G = 4096, ~2.9 us at
//    3.35 TB/s); but each evaluation costs operations that no design
//    avoids: 6 float32 and 2 int32 on every line (quantize, the largest
//    value), 7 int32 more on a line of the big_values region (class,
//    region, three LUT lookups, three sums) and 12 a count1 quad.  The
//    main path's first 4096-lane stepsize search needs ~7.1 evaluations a
//    granule with ~500 big_values lines each, ~8.5 us at the int32 rate:
//    operations bound its stepsize searches, not bytes.  And a
//    granule's evaluations depend on each other, a chain of ~1,500 warp
//    instructions each, which sets the time where few granules fill the
//    card.
//  - No evaluation whose outcome is known.  An evaluation is a pure
//    function of (granule, stepsize), so reusing one is exact: the
//    accepted stepsize's rows are kept (lane r holds row r), not evaluated
//    again; the walk starts from the bisection's hi where a mid fitted
//    (its bits fit: the walk takes no step); a bisection mid equal to the
//    evaluated lo or hi takes its known outcome; a down step ends the down
//    phase at its first miss (the plain search's later steps repeat it),
//    and misses without an evaluation below the floor, at the walk's last
//    rung (over budget) and at the bisection's evaluated lo.  runs, a row
//    of its own, counts the evaluations the kernel ran; evals keeps the
//    plain search's count.
//  - A granule's warps.  `width` warps share one granule: its spectrum in
//    shared memory (2,304 B; the registers drop from 109 to 64, so two
//    16-warp CTAs fit an SM), one exchange entry a warp (its rows and
//    flags, double-buffered), a named barrier (bar.sync 1 + slot) a pass.
//    Every warp keeps the same search state and takes the same outcome, so
//    control flow stays uniform.  A pass evaluates, at once, the bisection
//    mids of the next levels of the outcome tree (2^d - 1 warps for d
//    levels), or walk rungs q, q + 1, .. (the first that fits wins; the
//    40-step cap stays exact), or the down rungs (the prefix that fits is
//    kept).  The result is the serial schedule's for every width.
//  - How w is picked (search_plan): 3 where G x 3 warps fit the card's
//    resident warp slots (two CTAs of 16 warps an SM at 64 registers:
//    4,224), else 1: once G fills the card, the speculative evaluations
//    would only take slots from other granules.  Measured on an H100 80GB
//    HBM3 at 700 W on the main path's 512-lane searches, 3 beat 1 and 7
//    (the walks from a warm start mostly fit at their first rung); 7 stays
//    for tests and measurements.
//    A CTA holds up to 16 / w granules, fewer where G is small, so that
//    G = 512 covers the SMs instead of 32 of them, and stages the LUT with
//    16-byte loads (a CTA of 4 warps stages it in 5 of them a thread).
//  - Past the groups the grid holds (the corpus's 32,768 lanes), each
//    group takes its next granule from a counter as it finishes, so the
//    13 to 53 evaluations of a granule no longer leave warps idle behind
//    a slow one.  The launch's last draw sets the counter back to zero,
//    so no launch needs a zeroing kernel or a closing fence; where the
//    grid holds every granule, no group draws.
//  - Every stepsize of a search is an integer, so its factor 2^(-3q/16) is
//    read from a table that the wrapper computes with torch's own exp2: the
//    factor is the plain path's by construction.  A stepsize that is not an
//    integer in [-512, 511] sets the granule's status row to 1 and takes
//    exp2f (the wrapper returns the row; the tests hold it to 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libbits_at.so bits_at.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLines = 576;
constexpr int kVecs = kLines / 4;             // float4 per granule
constexpr int kRounds = (kVecs + 31) / 32;    // float4 per lane (5)
constexpr int kLastLane = (kVecs - 1) % 32;   // lane of the last float4 (15)
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTables = 32;
constexpr int kZeroRow = kTables;             // costs 0: an unused candidate
constexpr int kRow = 260;                     // LUT row stride in bytes
constexpr int kIxMax = 8191 + 14;
constexpr int kEsc = 8193;                    // ESC table entries (max - 15)
constexpr int kOut = 12;                      // output rows
constexpr unsigned kFull = 0xffffffffu;

// per-rate int32 table pack, as ops/bits_at.py:rate_tables lays it out
constexpr int kSfbL = 0;                      // 23 long sfb boundaries
constexpr int kSubdv = kSfbL + 23;            // 23 x 2 region-count inits
constexpr int kFirst = kSubdv + 46;           // 15 first tables by max
constexpr int kEscA = kFirst + 15;            // ESC table A by max - 15
constexpr int kEscB = kEscA + kEsc;           // ESC table B by max - 15

// K3: its rows after bits_at's (qss, evaluations, status, runs), the
// stepsizes of its istep75 table, and the searches' fixed bounds and steps
constexpr int kSearchOut = kOut + 4;
constexpr int kStepLo = -512;
constexpr int kStepCount = 1024;
constexpr int kDownSteps = 3;
constexpr float kQMin = -210.0f;
constexpr float kQMax = 45.0f;
// K3's launch: at most kMaxWidth warps a granule, kWarps warps a CTA; an
// exchange entry holds one evaluation's rows and its flags
constexpr int kMaxWidth = 7;
constexpr int kX = kOut + 1;

static_assert(kVecs % 32 == kLastLane + 1, "last round is partial");
static_assert(kRow % 4 == 0 && kRow >= 256, "LUT rows hold 256 classes");
static_assert(kSearchOut <= 32, "one lane writes each row");
static_assert(kWarps / 2 <= 15, "named barriers 1..15: one a granule of 2+");

// Tables every warp of a CTA reads, staged in shared memory once.
struct Tables {
  alignas(16) int8_t lut[(kTables + 1) * kRow];
  int sfb[23];
  int subdv[46];
  int first[15];
  int hlen[16];
};

// One evaluation's rows (bits_at's outputs for one granule).
struct Eval {
  float bits;
  int count1, big_values, r0, r1, a1, a2, ts0, ts1, ts2, c1_sel, ix_max;
};

struct Candidates {
  int t0, t1, t2;                             // LUT rows, kZeroRow if unused
};

// new_choose_table's candidates for a region whose largest value is mx
// (loop.c:1793-1899): the ESC pair, or the first table and its alternates.
__device__ __forceinline__ Candidates candidates(int mx, const int* first,
                                                 const int* __restrict__ rate) {
  if (mx == 0) return {kZeroRow, kZeroRow, kZeroRow};
  if (mx >= 15) {
    const int e = min(mx - 15, kEsc - 1);
    return {__ldg(rate + kEscA + e), __ldg(rate + kEscB + e), kZeroRow};
  }
  const int f = first[mx];
  switch (f) {
    case 2: return {2, 3, kZeroRow};
    case 5: return {5, 6, kZeroRow};
    case 7: return {7, 8, 9};
    case 10: return {10, 11, 12};
    case 13: return {13, 15, kZeroRow};
    default: return {f, kZeroRow, kZeroRow};
  }
}

// The choice among the candidates' sums s0, s1, s2, with the reference's
// order of tries and ties: an alternate wins when it is not larger; ESC
// takes table B only when it is strictly smaller.
__device__ __forceinline__ void choose(int mx, Candidates c, int s0, int s1,
                                       int s2, int& table, int& bits) {
  if (mx == 0) {
    table = 0;
    bits = 0;
  } else if (mx >= 15) {
    table = s1 < s0 ? c.t1 : c.t0;
    bits = min(s0, s1);
  } else {
    table = c.t0;
    bits = s0;
    if (c.t1 != kZeroRow && s1 <= bits) {
      table = c.t1;
      bits = s1;
    }
    if (c.t2 != kZeroRow && s2 <= bits) {
      table = c.t2;
      bits = s2;
    }
  }
}

// floor(xr75 * istep75 - 0.0946 + 0.5) clamped to [0, 2^31 - 128], each
// operation rounded to nearest as eager PyTorch computes it
__device__ __forceinline__ int quantize(float xr75, float istep75) {
  float v = __fadd_rn(__fsub_rn(__fmul_rn(xr75, istep75), 0.0946f), 0.5f);
  v = fminf(fmaxf(floorf(v), 0.0f), 2147483520.0f);
  return static_cast<int>(v);
}

__device__ __forceinline__ int pick(int r, int a, int b, int c) {
  return r == 0 ? a : (r == 1 ? b : c);
}

// Stage the LUT (33 rows: the 32 tables and the zero row), the sfb and
// subdivide tables, the first tables and the count1 lengths.
__device__ __forceinline__ void stage_tables(
    Tables& t, const int* __restrict__ rate,
    const int8_t* __restrict__ pair_bits, const int* __restrict__ c1_hlen) {
  const int4* pb16 = reinterpret_cast<const int4*>(pair_bits);
  for (int i = threadIdx.x; i < (kTables + 1) * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int4 w = r < kTables ? __ldg(pb16 + i) : make_int4(0, 0, 0, 0);
    int* dst = reinterpret_cast<int*>(t.lut + r * kRow) + 4 * (i & 15);
    dst[0] = w.x;
    dst[1] = w.y;
    dst[2] = w.z;
    dst[3] = w.w;
  }
  for (int i = threadIdx.x; i < 46; i += blockDim.x) {
    if (i < 23) t.sfb[i] = __ldg(rate + kSfbL + i);
    t.subdv[i] = __ldg(rate + kSubdv + i);
    if (i < 15) t.first[i] = __ldg(rate + kFirst + i);
    if (i < 16) t.hlen[i] = __ldg(c1_hlen + i);
  }
}

// The lane's share of a granule's |xr|^0.75: float4 i = 32k + lane, zeros
// past the last float4.
__device__ __forceinline__ void load_granule(const float4* __restrict__ row,
                                             int lane, float4 (&v)[kRounds]) {
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = 32 * k + lane;
    v[k] = i < kVecs ? __ldg(row + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The same share read from a granule's float4 in shared memory: v[k] is
// float4 32k + lane (read only where that is below kVecs).
struct SharedSpectrum {
  const float4* p;
  int lane;
  __device__ __forceinline__ float4 operator[](int k) const {
    return p[32 * k + lane];
  }
};

// One bit evaluation of one granule by its warp: quantize v (the lane's
// float4 in registers, or a SharedSpectrum) at the factor step, then count.
// Every field of the result is uniform in the warp.
template <class Spectrum>
__device__ __forceinline__ Eval evaluate(const Spectrum& v, float step,
                                         bool shrt, bool sblk,
                                         const Tables& t,
                                         const int* __restrict__ rate,
                                         int r0_pairs_short, int lane) {
  // ---- quantize; float4 i = 32k + lane holds pairs 2i and 2i + 1
  int ix[kRounds][4];
  int p_nz = -1;
  int p_big = -1;
  int imax = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = 32 * k + lane;
    if (i < kVecs) {
      const float4 x = v[k];
      ix[k][0] = quantize(x.x, step);
      ix[k][1] = quantize(x.y, step);
      ix[k][2] = quantize(x.z, step);
      ix[k][3] = quantize(x.w, step);
    } else {
      ix[k][0] = ix[k][1] = ix[k][2] = ix[k][3] = 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = ix[k][2 * h];
      const int y = ix[k][2 * h + 1];
      if ((x | y) != 0) p_nz = 2 * i + h;
      if (max(x, y) > 1) p_big = 2 * i + h;
      imax = max(imax, max(x, y));
    }
  }

  // ---- run lengths (loop.c:1488-1519): the last nonzero pair and the
  // last pair with a value > 1
  p_nz = __reduce_max_sync(kFull, p_nz);
  p_big = __reduce_max_sync(kFull, p_big);
  const int ix_max = __reduce_max_sync(kFull, imax);
  int count1 = (p_nz - p_big) >> 1;
  int big_values = p_nz + 1 - 2 * count1;
  if (shrt) {
    count1 = 0;
    big_values = 288;
  }

  // ---- subdivide (loop.c:1638-1703)
  const int* sfb = t.sfb;
  const int bvr = 2 * big_values;
  const int anz =
      min(__popc(__ballot_sync(kFull, lane < 23 && sfb[lane] < bvr)), 22);
  const int r0_init = t.subdv[2 * anz];
  const int r1_init = t.subdv[2 * anz + 1];
  int r0 = __reduce_max_sync(
      kFull, lane < 22 && lane <= r0_init && sfb[lane + 1] <= bvr ? lane : 0);
  int r1 = __reduce_max_sync(
      kFull, lane < 22 && lane <= r1_init &&
                     sfb[min(r0 + lane + 2, 22)] <= bvr
                 ? lane
                 : 0);
  int a1 = min(sfb[min(r0 + 1, 22)], bvr);
  int a2 = min(max(sfb[min(r0 + r1 + 2, 22)], a1), bvr);
  if (sblk && !shrt) {                        // start/stop blocks
    r0 = 7;
    r1 = 13;
    a1 = min(sfb[8], bvr);
    a2 = bvr;
  }
  if (shrt) {
    r0 = 8;
    r1 = 36;
  }
  if (big_values == 0) r0 = r1 = a1 = a2 = 0;

  // region of pair p: short blocks split at r0_pairs_short and count every
  // pair; long blocks split at a1, a2 and count pairs below 2 * big_values.
  // 3 marks a pair outside every region.
  auto region = [&](int p) {
    if (shrt) return p < r0_pairs_short ? 0 : 1;
    const int pos2 = 2 * p;
    if (pos2 >= bvr) return 3;
    return pos2 < a1 ? 0 : (pos2 < a2 ? 1 : 2);
  };

  // ---- region maxima, then each region's candidate tables
  int m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = region(2 * (32 * k + lane) + h);
      const int pm = max(ix[k][2 * h], ix[k][2 * h + 1]);
      if (r == 0) m0 = max(m0, pm);
      if (r == 1) m1 = max(m1, pm);
      if (r == 2) m2 = max(m2, pm);
    }
  }
  const int mx0 = __reduce_max_sync(kFull, m0);
  const int mx1 = __reduce_max_sync(kFull, m1);
  const int mx2 = __reduce_max_sync(kFull, m2);
  const Candidates c0 = candidates(mx0, t.first, rate);
  const Candidates c1 = candidates(mx1, t.first, rate);
  const Candidates c2 = candidates(mx2, t.first, rate);

  // ---- each pair's cost under its region's candidates; candidate j's
  // sums of the three regions share accj, 10 bits each.  Lanes past the
  // last float4 hold no pairs (a short block would count them).
  const int8_t* lut = t.lut;
  int acc0 = 0, acc1 = 0, acc2 = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int i = 32 * k + lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = region(2 * i + h);
      if (i < kVecs && r < 3) {
        const int cls = min(ix[k][2 * h], 15) * 16 + min(ix[k][2 * h + 1], 15);
        const int w = 1 << (10 * r);
        acc0 += lut[pick(r, c0.t0, c1.t0, c2.t0) * kRow + cls] * w;
        acc1 += lut[pick(r, c0.t1, c1.t1, c2.t1) * kRow + cls] * w;
        acc2 += lut[pick(r, c0.t2, c1.t2, c2.t2) * kRow + cls] * w;
      }
    }
  }
  int ts0, ts1, ts2, b0r, b1r, b2r;
  choose(mx0, c0, __reduce_add_sync(kFull, acc0 & 1023),
         __reduce_add_sync(kFull, acc1 & 1023),
         __reduce_add_sync(kFull, acc2 & 1023), ts0, b0r);
  choose(mx1, c1, __reduce_add_sync(kFull, (acc0 >> 10) & 1023),
         __reduce_add_sync(kFull, (acc1 >> 10) & 1023),
         __reduce_add_sync(kFull, (acc2 >> 10) & 1023), ts1, b1r);
  choose(mx2, c2, __reduce_add_sync(kFull, acc0 >> 20),
         __reduce_add_sync(kFull, acc1 >> 20),
         __reduce_add_sync(kFull, acc2 >> 20), ts2, b2r);
  if (shrt) {                                 // short blocks use regions 0, 1
    ts2 = 0;
    b2r = 0;
  }

  // ---- count1 quads from 2 * big_values on, 4-aligned by a roll of -2
  // lines where the start is only 2-aligned; index 8v + 4w + 2x + y
  const int start = 2 * big_values;
  const bool mis = (start & 3) != 0;
  const int lo = mis ? start - 2 : start;
  const int hi = lo + 4 * count1;
  int nib[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k)
    nib[k] = (min(ix[k][0], 1) << 3) | (min(ix[k][1], 1) << 2) |
             (min(ix[k][2], 1) << 1) | min(ix[k][3], 1);
  int b0raw = 0, signs = 0;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    // the next float4 (mod 144): lane + 1 of this round, or lane 0 of the
    // next round (of round 0 after the last float4)
    const int here = __shfl_sync(kFull, nib[k], (lane + 1) & 31);
    const int wrap = __shfl_sync(kFull, nib[k + 1 < kRounds ? k + 1 : 0], 0);
    const int next = lane == (k + 1 < kRounds ? 31 : kLastLane) ? wrap : here;
    const int i = 32 * k + lane;
    if (i < kVecs && 4 * i >= lo && 4 * i < hi) {
      const int p16 = mis ? ((nib[k] & 3) << 2) | (next >> 2) : nib[k];
      b0raw += t.hlen[p16];
      signs += __popc(p16);
    }
  }
  b0raw = __reduce_add_sync(kFull, b0raw);
  signs = __reduce_add_sync(kFull, signs);
  const int b0 = b0raw + signs;               // count1 table A
  const int b1 = 4 * count1 + signs;          // count1 table B
  const int c1_sel = b0 < b1 ? 0 : 1;
  const int total = b0r + b1r + b2r + (c1_sel == 0 ? b0 : b1);
  const float bits = ix_max <= kIxMax ? static_cast<float>(total) : 1e9f;
  return {bits, count1, big_values, r0, r1, a1, a2, ts0, ts1, ts2, c1_sel,
          ix_max};
}

// Row r (< kOut) of an evaluation, as an int32 (bits as float32 bits).
__device__ __forceinline__ int row_of(const Eval& e, int r) {
  const auto& [bits, count1, big_values, r0, r1, a1, a2, ts0, ts1, ts2,
               c1_sel, ix_max] = e;
  int v;
  switch (r) {
    case 0: v = __float_as_int(bits); break;
    case 1: v = count1; break;
    case 2: v = big_values; break;
    case 3: v = r0; break;
    case 4: v = r1; break;
    case 5: v = a1; break;
    case 6: v = a2; break;
    case 7: v = ts0; break;
    case 8: v = ts1; break;
    case 9: v = ts2; break;
    case 10: v = c1_sel; break;
    default: v = ix_max; break;
  }
  return v;
}

// Lanes 0..kOut-1 write the evaluation's rows of granule g into out
// (rows x n int32).
__device__ __forceinline__ void store_rows(const Eval& e, int lane, int n,
                                           int g, int* __restrict__ out) {
  if (lane < kOut) out[static_cast<size_t>(lane) * n + g] = row_of(e, lane);
}

__global__ void __launch_bounds__(kThreads, 2)
bits_at_kernel(const float4* __restrict__ xr75p,
               const float* __restrict__ istep75,
               const uint8_t* __restrict__ is_short,
               const uint8_t* __restrict__ is_short_block,
               const int* __restrict__ rate,
               const int8_t* __restrict__ pair_bits,
               const int* __restrict__ c1_hlen, int r0_pairs_short, int n,
               int* __restrict__ out) {
  __shared__ Tables t;
  stage_tables(t, rate, pair_bits, c1_hlen);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n;
       g += gridDim.x * kWarps) {
    float4 v[kRounds];
    load_granule(xr75p + static_cast<size_t>(g) * kVecs, lane, v);
    const Eval e = evaluate(v, __ldg(istep75 + g), is_short[g] != 0,
                            is_short_block[g] != 0, t, rate, r0_pairs_short,
                            lane);
    store_rows(e, lane, n, g, out);
  }
}

// max(a, b) as torch.clamp and torch.maximum give it: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float bisect_mid(float lo, float hi) {
  return floorf(__fmul_rn(__fadd_rn(lo, hi), 0.5f));
}

// K3's passes: bisection rounds, walk-up rungs, down rungs, and the end.
enum class Pass { kBisect, kWalk, kDown, kDone };

// The warps of one granule meet at named barrier `id` (1..15; 0 is
// __syncthreads'); a granule of one warp needs only __syncwarp.
__device__ __forceinline__ void group_sync(int id, int width) {
  if (width > 1)
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * width) : "memory");
  else
    __syncwarp();
}

// The factor 2^(-3q/16) of stepsize q: torch's, from the table, for an
// integer in [kStepLo, kStepLo + kStepCount); else exp2f, and status 1.
__device__ __forceinline__ float step_factor(float q,
                                             const float* __restrict__ tab,
                                             int& status) {
  if (q == floorf(q) && q >= static_cast<float>(kStepLo) &&
      q < static_cast<float>(kStepLo + kStepCount))
    return __ldg(tab + (static_cast<int>(q) - kStepLo));
  status = 1;
  return exp2f(__fmul_rn(-0.1875f, q));
}

// Node `node` of a bisection round from (lo, hi), in heap order: node j's
// children are 2j + 1 where mid j does not fit and 2j + 2 where it fits.
// Returns the node's mid on the outcomes its path assumes.  A mid equal to
// a bound whose outcome is known (lo_known: lo did not fit; hi_known: hi
// fits; the path's assumed mids count as known) needs no evaluation, and
// a path that assumes the opposite of a known outcome is never taken:
// `active` says that neither holds.
__device__ __forceinline__ float tree_mid(int node, float lo, float hi,
                                          bool lo_known, bool hi_known,
                                          bool& active) {
  const int level = 31 - __clz(node + 1);
  const int path = node + 1 - (1 << level);
  bool taken = true;
  for (int l = level - 1; l >= 0; --l) {
    const bool fits = (path >> l) & 1;
    const float mid = bisect_mid(lo, hi);
    if ((lo_known && mid == lo && fits) || (hi_known && mid == hi && !fits))
      taken = false;
    if (fits) {
      hi = mid;
      hi_known = true;
    } else {
      lo = mid;
      lo_known = true;
    }
  }
  const float mid = bisect_mid(lo, hi);
  active = taken && !(lo_known && mid == lo) && !(hi_known && mid == hi);
  return mid;
}

// K3.  walk = 0: search_stepsize from qanf (start) and the optional warm
// bound qss_lo; walk = 1: search_walk from start.  A CTA holds `groups`
// granules at a time, `width` warps each (blockDim.x = 32 * width *
// groups).  Dynamic shared memory holds each granule's |xr|^0.75 and its
// exchange: two buffers of `width` entries of kX ints, one entry a warp
// (its evaluation's rows, then its flags: 1 if it evaluated, 2 if a
// stepsize missed the table).  out is (kSearchOut, n).  counter: one
// int32, zero between launches.  Each group starts at granule
// blockIdx.x * groups + slot; where the batch holds more granules than the
// grid holds groups, a group that finishes takes its next from counter.
// Those draws are exactly n (one a granule past the grid, one more that
// ends each group), so the draw that returns n - 1 is the launch's last
// and sets the counter back to zero.
__global__ void __launch_bounds__(kThreads, 2)
search_kernel(const float4* __restrict__ xr75p,
              const float* __restrict__ budget,
              const float* __restrict__ start,
              const float* __restrict__ qss_lo,
              const uint8_t* __restrict__ is_short,
              const uint8_t* __restrict__ is_short_block,
              const int* __restrict__ rate,
              const int8_t* __restrict__ pair_bits,
              const int* __restrict__ c1_hlen,
              const float* __restrict__ istep_tab, int r0_pairs_short,
              int walk, int n_bisect, int max_steps, int width, int groups,
              int n, int* __restrict__ out, int* __restrict__ counter) {
  __shared__ Tables t;
  __shared__ int next_g[kWarps];               // a group's next granule
  extern __shared__ float4 dyn[];
  stage_tables(t, rate, pair_bits, c1_hlen);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) / width;       // the CTA's granule
  const int sub = (threadIdx.x >> 5) - slot * width;  // the warp in it
  const int tid = threadIdx.x - 32 * width * slot;
  float4* spec = dyn + slot * kVecs;
  int* xch = reinterpret_cast<int*>(dyn + groups * kVecs) +
             slot * 2 * width * kX;
  const SharedSpectrum v{spec, lane};
  const int depth_max = 31 - __clz(width + 1);      // tree levels a round
  const int grid = gridDim.x * groups;               // granule groups

  for (int g = blockIdx.x * groups + slot; g < n;) {
    const float4* row = xr75p + static_cast<size_t>(g) * kVecs;
    for (int i = tid; i < kVecs; i += 32 * width) spec[i] = __ldg(row + i);
    const float b = __ldg(budget + g);
    const bool shrt = is_short[g] != 0;
    const bool sblk = is_short_block[g] != 0;
    group_sync(1 + slot, width);

    float qss = __ldg(start + g);   // the accepted stepsize; the walk's base
    int kept = 0;                   // lane r < kOut: row r at qss (at hi
                                    // while bisecting)
    float floor_q = kQMin;
    float lo = kQMin;
    float hi = kQMax;
    bool lo_known = false;          // lo was evaluated and did not fit
    bool hi_known = false;          // hi was evaluated and fits
    float below = 0.0f;             // the walk's last rung over budget
    bool below_known = false;
    int left = 0;                   // bisection steps left
    int steps = 0;                  // walk steps
    int first = 0;                  // the walk's next rungs: qss + first ..
    int down = 0;                   // down steps taken
    Pass pass = Pass::kWalk;
    if (!walk) {
      floor_q = nan_max(qss, kQMin);
      lo = qss_lo != nullptr ? nan_max(floor_q, __ldg(qss_lo + g)) : floor_q;
      left = n_bisect;
      pass = Pass::kBisect;
    }
    int runs = 0;
    int status = 0;
    int buf = 0;
    for (;;) {
      // ---- this pass's candidates: tree nodes or ladder rungs
      int cnt = 0;
      if (pass == Pass::kBisect) {
        if (left == 0) {
          // hi fits where it was evaluated: the walk up takes no step and
          // its first evaluation is hi's, already kept
          qss = hi;
          pass = hi_known ? Pass::kDown : Pass::kWalk;
          continue;
        }
        cnt = (1 << min(depth_max, left)) - 1;
      } else if (pass == Pass::kWalk) {
        cnt = min(width, max_steps - steps - first + 1);
      } else if (pass == Pass::kDown) {
        // rungs qss - 1, qss - 2, .. up to the first that is known not to
        // fit: below the floor, the walk's last rung, or a bisection lo
        float q = qss;
        const int most = min(width, kDownSteps - down);
        while (cnt < most) {
          q = __fsub_rn(q, 1.0f);
          if (!(q >= floor_q) || (below_known && q == below) ||
              (lo_known && q == lo))
            break;
          ++cnt;
        }
        if (cnt == 0) pass = Pass::kDone;
      }
      if (pass == Pass::kDone) break;

      // ---- this warp's candidate, evaluated into its exchange entry
      float q = qss;
      bool active = sub < cnt;
      if (pass == Pass::kBisect) {
        if (active) q = tree_mid(sub, lo, hi, lo_known, hi_known, active);
      } else if (active) {
        const int k = pass == Pass::kWalk ? first + sub : sub + 1;
        for (int i = 0; i < k; ++i)
          q = pass == Pass::kWalk ? __fadd_rn(q, 1.0f) : __fsub_rn(q, 1.0f);
      }
      int* x = xch + buf * width * kX;
      if (active) {
        int st = 0;
        const float f = step_factor(q, istep_tab, st);
        const Eval e =
            evaluate(v, f, shrt, sblk, t, rate, r0_pairs_short, lane);
        if (lane < kOut) x[sub * kX + lane] = row_of(e, lane);
        if (lane == kOut) x[sub * kX + kOut] = 1 | (st << 1);
      } else if (lane == kOut) {
        x[sub * kX + kOut] = 0;
      }
      group_sync(1 + slot, width);
      if (sub == 0) {
        for (int k = 0; k < width; ++k) {
          const int fl = x[k * kX + kOut];
          runs += fl & 1;
          status |= fl >> 1;
        }
      }

      // ---- every warp of the granule takes the same outcome
      if (pass == Pass::kBisect) {
        // follow the outcomes from the root: ok -> hi = mid, else lo = mid
        const int depth = min(depth_max, left);
        int node = 0;
        for (int l = 0; l < depth; ++l) {
          const float mid = bisect_mid(lo, hi);
          bool fits;
          if (lo_known && mid == lo) {
            fits = false;
          } else if (hi_known && mid == hi) {
            fits = true;
          } else {
            fits = __int_as_float(x[node * kX]) <= b;
            if (fits && lane < kOut) kept = x[node * kX + lane];
          }
          if (fits) {
            hi = mid;
            hi_known = true;
          } else {
            lo = mid;
            lo_known = true;
          }
          node = 2 * node + (fits ? 2 : 1);
        }
        left -= depth;
      } else if (pass == Pass::kWalk) {
        // rung j is qss + first + j: step up to the first that fits, or to
        // the last rung
        float r = qss;
        if (first) {
          below = qss;
          below_known = true;
          r = __fadd_rn(qss, 1.0f);
        }
        int j = 0;
        for (;;) {
          if (lane < kOut) kept = x[j * kX + lane];
          if (!(__int_as_float(x[j * kX]) > b) || j + 1 == cnt) break;
          below = r;
          below_known = true;
          r = __fadd_rn(r, 1.0f);
          ++j;
        }
        qss = r;
        steps += first + j;
        first = 1;
        if (!(__int_as_float(x[j * kX]) > b) || steps >= max_steps)
          pass = walk ? Pass::kDone : Pass::kDown;
      } else {
        // the down rungs: keep the prefix that fits
        float r = qss;
        int j = 0;
        for (; j < cnt; ++j) {
          r = __fsub_rn(r, 1.0f);
          if (!(__int_as_float(x[j * kX]) <= b)) break;
          qss = r;
          if (lane < kOut) kept = x[j * kX + lane];
        }
        down += j;
        if (j < cnt || down == kDownSteps) pass = Pass::kDone;
      }
      buf ^= 1;
    }

    if (sub == 0) {
      const size_t at = static_cast<size_t>(lane) * n + g;
      if (lane < kOut)
        out[at] = kept;
      else if (lane == kOut)
        out[at] = __float_as_int(qss);
      else if (lane == kOut + 1)
        out[at] = walk ? steps + 2 : n_bisect + 5 + steps;
      else if (lane == kOut + 2)
        out[at] = status;
      else if (lane == kOut + 3)
        out[at] = runs;
    }
    if (n <= grid) break;                            // nothing to draw
    if (sub == 0 && lane == 0) {
      const int k = atomicAdd(counter, 1);
      if (k == n - 1) atomicExch(counter, 0);
      next_g[slot] = grid + k;
    }
    group_sync(1 + slot, width);
    g = next_g[slot];
  }
}

int device_sms() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(sms, 1);
}

// K3's launch for n granules.
struct Plan {
  int width;    // warps a granule
  int groups;   // granules a CTA at a time
  int threads;  // 32 * width * groups
  int blocks;
  int smem;     // dynamic shared memory, bytes
};

int search_smem(int width, int groups) {
  return groups * (kVecs * 16 + 2 * width * kX * 4);
}

int search_per_sm(int threads, int smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, search_kernel,
                                                threads, smem);
  return max(per_sm, 1);
}

// width 0 picks it: 3 where n granules of 3 warps fit in the card's
// resident warp slots (a CTA of kWarps one-warp granules counts them),
// else 1.  A CTA takes up to kWarps / width granules, fewer where n is
// small, so that n / groups CTAs cover every SM.
Plan search_plan(int n, int width) {
  const int sms = device_sms();
  if (width <= 0) {
    const long slots = static_cast<long>(search_per_sm(
                           kThreads, search_smem(1, kWarps))) *
                       kWarps * sms;
    width = static_cast<long>(n) * 3 <= slots ? 3 : 1;
  }
  Plan p;
  p.width = min(max(width, 1), kMaxWidth);
  p.groups = max(1, min(kWarps / p.width, (n + sms - 1) / sms));
  p.threads = 32 * p.width * p.groups;
  p.smem = search_smem(p.width, p.groups);
  p.blocks = min((n + p.groups - 1) / p.groups,
                 search_per_sm(p.threads, p.smem) * sms);
  return p;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.  out is (12, n) int32:
// bits (as float32 bits), count1, big_values, r0, r1, a1, a2,
// table_select[0..2], count1table_select, ix_max.
extern "C" int mp3_bits_at(const void* xr75p, const void* istep75,
                           const void* is_short, const void* is_short_block,
                           const void* rate, const void* pair_bits,
                           const void* c1_hlen, int r0_pairs_short,
                           int n_granules, void* out, void* stream) {
  if (n_granules > 0) {
    const int blocks =
        min((n_granules + kWarps - 1) / kWarps, 2 * device_sms());
    bits_at_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(xr75p), static_cast<const float*>(istep75),
        static_cast<const uint8_t*>(is_short),
        static_cast<const uint8_t*>(is_short_block),
        static_cast<const int*>(rate), static_cast<const int8_t*>(pair_bits),
        static_cast<const int*>(c1_hlen), r0_pairs_short, n_granules,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's launch for n granules at `width` warps a granule (0: picked as
// search_plan says): plan receives width, groups, threads, blocks and the
// dynamic shared memory in bytes.  Returns cudaGetLastError().
extern "C" int mp3_search_plan(int n_granules, int width, int* plan) {
  const Plan p = search_plan(max(n_granules, 1), width);
  plan[0] = p.width;
  plan[1] = p.groups;
  plan[2] = p.threads;
  plan[3] = p.blocks;
  plan[4] = p.smem;
  return static_cast<int>(cudaGetLastError());
}

// K3 on `stream`; returns cudaGetLastError().  start is qanf (walk = 0) or
// the warm start (walk = 1); qss_lo may be null.  istep_tab holds
// 2^(-0.1875 q) for q = -512..511.  width: warps a granule, 0 to pick.
// counter: one int32 on the device, zero, used by no other stream's
// launch at the same time; past the grid the granule groups share out the
// batch through it, and the launch leaves it at zero.
// out is (16, n) int32: bits_at's 12 rows at the accepted stepsize, then
// qss (as float32 bits), the granule's bit evaluations as the plain search
// counts them, its status (0, or 1 where a stepsize missed the table) and
// the evaluations the kernel ran for it.
extern "C" int mp3_search(const void* xr75p, const void* budget,
                          const void* start, const void* qss_lo,
                          const void* is_short, const void* is_short_block,
                          const void* rate, const void* pair_bits,
                          const void* c1_hlen, const void* istep_tab,
                          int r0_pairs_short, int walk, int n_bisect,
                          int max_steps, int width, int n_granules, void* out,
                          void* counter, void* stream) {
  if (n_granules > 0) {
    const Plan p = search_plan(n_granules, width);
    search_kernel<<<p.blocks, p.threads, p.smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(xr75p), static_cast<const float*>(budget),
        static_cast<const float*>(start), static_cast<const float*>(qss_lo),
        static_cast<const uint8_t*>(is_short),
        static_cast<const uint8_t*>(is_short_block),
        static_cast<const int*>(rate), static_cast<const int8_t*>(pair_bits),
        static_cast<const int*>(c1_hlen),
        static_cast<const float*>(istep_tab), r0_pairs_short, walk, n_bisect,
        max_steps, p.width, p.groups, n_granules, static_cast<int*>(out),
        static_cast<int*>(counter));
  }
  return static_cast<int>(cudaGetLastError());
}
