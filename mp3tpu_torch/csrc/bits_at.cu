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
// granule it runs the search of mp3tpu_torch/ops/loop.py's lockstep plain
// versions, search_stepsize_plain (an 8-step bisection of the stepsize on
// [max(qanf, QMIN, qss_lo), QMAX], a walk up while over budget, at most 40
// steps, and 3 downward steps that keep a finer stepsize that still fits)
// or search_walk_plain (the walk up from a warm start), then evaluates the
// accepted stepsize once more for its counts.  The plain versions step the
// whole batch until its slowest granule fits, but each granule's update is
// masked and depends on that granule alone, so a loop per granule with the
// same caps gives the same stepsizes, bits and counts.
//  - Layout: bits_at's.  One warp runs one granule's whole search to its own
//    exit; the loop control depends only on that granule, so it is uniform
//    in the warp.  The warps of a CTA finish at different times (a granule
//    makes 13 to 53 evaluations); balancing them is later work.
//  - Each lane loads its 18 values of |xr|^0.75 once, as bits_at does, and
//    keeps them in registers for every evaluation of the search.
//  - One evaluation per pass of one loop, so the evaluation is inlined once.
//  - Every stepsize of a search is an integer, so its factor 2^(-3q/16) is
//    read from a table that the wrapper computes with torch's own exp2: the
//    factor is the plain path's by construction.  A stepsize that is not an
//    integer in [-512, 511] sets the granule's status row to 1 and takes
//    exp2f (the wrapper returns the row; the tests hold it to 0).
//  - What bounds it: per granule 2,304 bytes in, ~20 bytes of scalars and
//    60 bytes of rows out (~9.8 MB at G = 4096, ~2.9 us at 3.35 TB/s); but
//    a granule's 13 or more dependent evaluations of ~1,500 warp
//    instructions each form a latency chain, which sets the time at the
//    main path's widths as it does for bits_at.
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

// K3: its rows after bits_at's (qss, evaluations, status), the stepsizes of
// its istep75 table, and the searches' fixed bounds and steps
constexpr int kSearchOut = kOut + 3;
constexpr int kStepLo = -512;
constexpr int kStepCount = 1024;
constexpr int kDownSteps = 3;
constexpr float kQMin = -210.0f;
constexpr float kQMax = 45.0f;

static_assert(kVecs % 32 == kLastLane + 1, "last round is partial");
static_assert(kRow % 4 == 0 && kRow >= 256, "LUT rows hold 256 classes");
static_assert(kSearchOut <= 32, "one lane writes each row");

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
  const int* pb4 = reinterpret_cast<const int*>(pair_bits);
  for (int i = threadIdx.x; i < (kTables + 1) * 64; i += kThreads) {
    const int r = i >> 6;
    reinterpret_cast<int*>(t.lut + r * kRow)[i & 63] =
        r < kTables ? __ldg(pb4 + i) : 0;
  }
  if (threadIdx.x < 23) t.sfb[threadIdx.x] = __ldg(rate + kSfbL + threadIdx.x);
  if (threadIdx.x < 46)
    t.subdv[threadIdx.x] = __ldg(rate + kSubdv + threadIdx.x);
  if (threadIdx.x < 15)
    t.first[threadIdx.x] = __ldg(rate + kFirst + threadIdx.x);
  if (threadIdx.x < 16) t.hlen[threadIdx.x] = __ldg(c1_hlen + threadIdx.x);
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

// One bit evaluation of one granule by its warp: quantize v at the factor
// step, then count.  Every field of the result is uniform in the warp.
__device__ __forceinline__ Eval evaluate(const float4 (&v)[kRounds],
                                         float step, bool shrt, bool sblk,
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
      ix[k][0] = quantize(v[k].x, step);
      ix[k][1] = quantize(v[k].y, step);
      ix[k][2] = quantize(v[k].z, step);
      ix[k][3] = quantize(v[k].w, step);
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

// Lanes 0..kOut-1 write the evaluation's rows of granule g into out
// (rows x n int32).
__device__ __forceinline__ void store_rows(const Eval& e, int lane, int n,
                                           int g, int* __restrict__ out) {
  const auto& [bits, count1, big_values, r0, r1, a1, a2, ts0, ts1, ts2,
               c1_sel, ix_max] = e;
  if (lane < kOut) {
    int v;
    switch (lane) {
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
    out[static_cast<size_t>(lane) * n + g] = v;
  }
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

// The search's phases: bisection, the first evaluation of the walk up, the
// walk up, the downward steps, and the final evaluation at the result.
enum Phase { kBisect, kWalkStart, kWalkUp, kWalkDown, kFinal };

// K3.  walk = 0: search_stepsize from qanf (start) and the optional warm
// bound qss_lo; walk = 1: search_walk from start.  out is (kSearchOut, n).
__global__ void __launch_bounds__(kThreads, 1)
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
              int walk, int n_bisect, int max_steps, int n,
              int* __restrict__ out) {
  __shared__ Tables t;
  __shared__ float istep[kStepCount];
  stage_tables(t, rate, pair_bits, c1_hlen);
  for (int i = threadIdx.x; i < kStepCount; i += kThreads)
    istep[i] = __ldg(istep_tab + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < n;
       g += gridDim.x * kWarps) {
    float4 v[kRounds];
    load_granule(xr75p + static_cast<size_t>(g) * kVecs, lane, v);
    const float b = __ldg(budget + g);
    const bool shrt = is_short[g] != 0;
    const bool sblk = is_short_block[g] != 0;

    float qss = __ldg(start + g);             // the accepted stepsize
    float bits = 0.0f;                        // its bits
    float floor_q = kQMin;
    float lo = kQMin;
    float hi = kQMax;
    Phase phase = kWalkStart;
    if (!walk) {
      floor_q = nan_max(qss, kQMin);
      lo = qss_lo != nullptr ? nan_max(floor_q, __ldg(qss_lo + g)) : floor_q;
      qss = hi;
      if (n_bisect > 0) phase = kBisect;
    }
    float q = phase == kBisect ? bisect_mid(lo, hi) : qss;
    int step = 0;                             // steps taken in this phase
    int evals = 0;
    int status = 0;
    for (;;) {
      float factor;
      if (q == floorf(q) && q >= static_cast<float>(kStepLo) &&
          q < static_cast<float>(kStepLo + kStepCount)) {
        factor = istep[static_cast<int>(q) - kStepLo];
      } else {
        status = 1;
        factor = exp2f(__fmul_rn(-0.1875f, q));
      }
      const Eval e =
          evaluate(v, factor, shrt, sblk, t, rate, r0_pairs_short, lane);
      ++evals;
      if (phase == kFinal) {
        store_rows(e, lane, n, g, out);
        break;
      }
      if (phase == kBisect) {                 // ok: hi = mid, else lo = mid
        if (e.bits <= b)
          hi = q;
        else
          lo = q;
        if (++step < n_bisect) {
          q = bisect_mid(lo, hi);
        } else {
          phase = kWalkStart;
          q = hi;
        }
        continue;
      }
      if (phase == kWalkDown) {               // keep a finer stepsize that fits
        if (e.bits <= b && q >= floor_q) {
          qss = q;
          bits = e.bits;
        }
        ++step;
      } else {                                // kWalkStart, kWalkUp
        step = phase == kWalkStart ? 0 : step + 1;
        phase = kWalkUp;
        qss = q;
        bits = e.bits;
        if (step < max_steps && bits > b) {
          q = __fadd_rn(qss, 1.0f);
          continue;
        }
        if (!walk) {
          phase = kWalkDown;
          step = 0;
        }
      }
      if (phase == kWalkDown && step < kDownSteps) {
        q = __fsub_rn(qss, 1.0f);
        continue;
      }
      phase = kFinal;
      q = qss;
    }
    const size_t at = static_cast<size_t>(lane) * n + g;
    if (lane == kOut)
      out[at] = __float_as_int(qss);
    else if (lane == kOut + 1)
      out[at] = evals;
    else if (lane == kOut + 2)
      out[at] = status;
  }
}

int device_sms() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(sms, 1);
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

// K3 on `stream`; returns cudaGetLastError().  start is qanf (walk = 0) or
// the warm start (walk = 1); qss_lo may be null.  istep_tab holds
// 2^(-0.1875 q) for q = -512..511.  out is (15, n) int32: bits_at's 12 rows
// at the accepted stepsize, then qss (as float32 bits), the granule's bit
// evaluations and its status (0, or 1 where a stepsize missed the table).
extern "C" int mp3_search(const void* xr75p, const void* budget,
                          const void* start, const void* qss_lo,
                          const void* is_short, const void* is_short_block,
                          const void* rate, const void* pair_bits,
                          const void* c1_hlen, const void* istep_tab,
                          int r0_pairs_short, int walk, int n_bisect,
                          int max_steps, int n_granules, void* out,
                          void* stream) {
  if (n_granules > 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, search_kernel,
                                                  kThreads, 0);
    const int blocks = min((n_granules + kWarps - 1) / kWarps,
                           max(per_sm, 1) * device_sms());
    search_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(xr75p), static_cast<const float*>(budget),
        static_cast<const float*>(start), static_cast<const float*>(qss_lo),
        static_cast<const uint8_t*>(is_short),
        static_cast<const uint8_t*>(is_short_block),
        static_cast<const int*>(rate), static_cast<const int8_t*>(pair_bits),
        static_cast<const int*>(c1_hlen),
        static_cast<const float*>(istep_tab), r0_pairs_short, walk, n_bisect,
        max_steps, n_granules, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
