// Layer I/II bit allocation (K5) for Hopper: one warp a frame.
//
// Replaces the host code of the JAX package's Layer I/II path,
// mp3tpu/runtime/alloc12.py: joint_mode (the joint-stereo decision,
// encode.c:888-955, with bits_for_nonoise, encode.c:782-860) and
// greedy_allocation (the greedy min-MNR water filling, encode.c:983-1173),
// which mp3tpu/encoder.py:803-813 runs on the host between the device
// analysis and the device quantizers.  Its plain version is that numpy code
// itself (the port's byte-equal copy, mp3tpu_torch/runtime/alloc12.py,
// through ops/alloc12.py), which runs every frame in lockstep; the
// sequential oracles are numpy_ref/layer12.py _a_bit_allocation_II / _I.
//
// A frame carries no state to the next, so a frame is a warp.  Lane i holds
// the candidates (sb = i, ch = 0) and (sb = i, ch = 1), the flat indices 2i
// and 2i + 1 of the reference's sb-outer, ch-inner scan.
//
// alloc12_kernel (K5, launched by mp3_alloc12).  A greedy step:
//   1. each lane holds the order key of its two candidates (a uint64 whose
//      unsigned order is numpy's argmin order: every NaN 0, -0.0 as +0.0,
//      else the sign-flip map; a frozen candidate or none carries the key
//      of INF = 1e30, and +inf loses even to it) and offers the smaller
//      (channel 0 on a tie).  The warp takes the smallest key in two
//      halves: __reduce_min_sync (redux.sync) on the high words, then on
//      the low words of the lanes that hold that high word, and a ballot of
//      the lanes that hold both; __ffs picks the lowest, which is the lower
//      flat index, as numpy's argmin picks;
//   2. every lane reads the exit from the smallest key, which the
//      reductions left in uniform registers: the frame ends unless it is
//      below the limit's (Layer II: INF's; Layer I: that of
//      np.minimum(mnr[0][0] + 1, INF), 0 when NaN).  A NaN candidate would
//      be the first step's argmin and end the frame there; a frame that
//      holds one walks no step, and no step makes a NaN;
//   3. beside the reductions, every lane prices the step its better
//      candidate would take, in integers (every cost and 6 * SFS_PER_SCFSI
//      is an integer: a step's sample bits from ba = k, cost[min(k + 1,
//      15)] - (k ? cost[k] : 0), is a table, and a channel's first step
//      adds its selection and scale-factor bits), tests the fit against the
//      bits left, and computes its new key (INF's when it freezes);
//   4. the winner's bits taken (0 when it does not fit) go to every lane
//      with one __shfl_sync, which subtracts them from its copy of the bits
//      left; the winner alone commits its new keys and allocations (the
//      joint channel above jsbound copied on either outcome).  On Layer I,
//      when lane 0 wins and its channel-0 allocation moves, lane 0 shuffles
//      that allocation and every lane recomputes the limit,
//      -smr[0][0] + snr_after[ba] + 1, in numpy's order.
// The state (the two keys and allocations) lives in registers and is never
// indexed by the winning channel; each warp's SMR sits in shared memory.
// The one float64 operation of a step, -smr + snr_after[ba], rounds as
// numpy's does (-fmad=false); it never makes a NaN or a -0.0 (no snr_after
// is signed), so the step's key is the sign-flip map alone.  A frame whose
// joint channels all lie above sblimit (stereo and mono modes) runs the
// walk without the copy's second key.  The joint decision sums the lanes'
// integer bits_for_nonoise with __reduce_add_sync; each lane finds its
// subband's rung on the ascending SNR ladder by a linear search of at most
// 15 entries (numpy's searchsorted(side="left"); a NaN SMR sorts last).
//
// What bounds it (chip_smoke.py k5_bound): the warp instructions of every
// frame's steps at the SMs' rates (a step runs ~60, most on the 32-bit
// integer pipe; chip_smoke.py counts them in the SASS), above the longest
// frame's steps on one warp's dependent path (two redux.sync, a ballot,
// __ffs and the winner's commit); the bytes (the SMR in float64, the scfsi
// and the outputs) are ~1.4 MB on a 60 s stereo clip, under a microsecond
// at the HBM rate.  At 32 registers a thread, 16 blocks of 4 warps fit on
// an SM, so the 60 s Layer I clip's 6,891 frames run in one wave on 132
// SMs, and a short clip's frames spread evenly over the SMs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o liballoc12.so alloc12.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kInf = 1e30;   // runtime/alloc12.py INF

// the tables of one (layer, table), from ops/alloc12.py kernel_tables:
// float64 snr_after, cost and ladder (32 x 16 each) and 6 * SFS_PER_SCFSI
// (4); int32 maxba, nbal, ladder bound (32 each) and the four jsbounds
constexpr int kD = 3 * 512 + 4;
constexpr int kI = 3 * 32 + 4;

struct Params {
  int F, layer, nch, sblimit, adb, ep, joint, mode, mode_joint, mode_stereo;
};

// ---------------------------------------------------------------------------
// K5 (alloc12_kernel)
// ---------------------------------------------------------------------------

// K5's block: 4 warps (frames), 16 blocks an SM at 32 registers a
// thread (64 warps: the 60 s Layer I clip's 6,891 frames in one wave on
// 132 SMs; small blocks spread a short clip's frames evenly over the SMs)
constexpr int kK5Warps = 4;
constexpr int kBlocksPerSM = 16;

typedef unsigned long long u64;

// the sign-flip map: the unsigned order of the keys is the order of the
// non-NaN float64 values, -0.0 just below +0.0
__device__ __forceinline__ u64 flip(double x) {
  const unsigned hi = static_cast<unsigned>(__double2hiint(x));
  const unsigned lo = static_cast<unsigned>(__double2loint(x));
  const unsigned s = static_cast<unsigned>(static_cast<int>(hi) >> 31);
  return (static_cast<u64>(hi ^ (s | 0x80000000u)) << 32) | (lo ^ s);
}

// numpy's argmin order as an unsigned key: every NaN 0, before every value;
// -0.0 as +0.0, so that equal values tie
__device__ __forceinline__ u64 order_key(double x) {
  if (x != x) return 0ull;
  return flip(x == 0.0 ? 0.0 : x);
}

// Layer I's limit np.minimum(mnr[0][0] + 1, INF) as a key (a NaN limit: 0,
// which no key is below)
__device__ __forceinline__ u64 limit_key(double l) {
  return order_key(l != l || l < kInf ? l : kInf);
}

// searchsorted(ladder[sb][:bound], x, side="left") on an ascending ladder
__device__ __forceinline__ int rung_g(const double* __restrict__ lad,
                                      int bound, double x) {
  int k = 0;
  while (k < bound && (lad[k] < x || x != x)) ++k;
  return k;
}

// bits_for_nonoise (runtime/alloc12.py:41) of this lane's subband at
// jsbound jb, in integers (`cost`: the subband's row, integer-valued); the
// warp's sum is the frame's requirement
template <int kLayer>
__device__ __forceinline__ int nonoise_bits(int sb, int jb, int k0, int k1,
                                            int scf0, int scf1,
                                            const double* __restrict__ cost,
                                            const int* sfs6,
                                            const int* nbal,
                                            const Params& p) {
  const bool js = sb >= jb;
  const bool both = p.nch == 2 && js;
  const bool second = p.nch == 2 && !js;
  const int ke0 = both ? max(k0, k1) : k0;
  if (kLayer == 1) {
    int req = (ke0 > 0 ? (ke0 + 1) * 12 + 6 * (js ? p.nch : 1) : 0) +
              (second && k1 > 0 ? (k1 + 1) * 12 + 6 : 0);
    if (sb == 0) req += 32 + 4 * (jb * p.nch + (32 - jb));
    return req;
  }
  int req = 0;
  if (sb < p.sblimit) {
    const int sel = both ? 4 : 2;
    const int sc0 = sfs6[scf0] + (both ? sfs6[scf1] : 0);
    const int sc1 = sfs6[scf1] + (both ? sfs6[scf0] : 0);
    req = (ke0 > 0 ? static_cast<int>(cost[ke0]) + sel + sc0 : 0) +
          (second && k1 > 0 ? static_cast<int>(cost[k1]) + sel + sc1 : 0) +
          nbal[sb] * (js ? 1 : p.nch);
  }
  if (sb == 0) req += 32 + (p.ep ? 16 : 0);
  return req;
}

// a lane's state in the greedy walk: each channel's candidate key (a
// frozen candidate, or none: INF's) and allocation
struct Lane {
  u64 k0, k1;
  int ba0, ba1;
};

// The greedy walk of one frame until its exit; returns its steps.  `smr`
// is this lane's SMR in shared memory, {ch 0, ch 1}, and `smr00` lane 0's
// channel 0; `stp` and `snr` this lane's column of the step and SNR tables
// and `snr0` lane 0's; `left` the bits left, updated in place.  kCopy: some lane below sblimit copies
// each step to its other channel (joint stereo); a frame without one runs
// the walk without the copy's second key.
template <int kLayer, bool kCopy>
__device__ __forceinline__ int walk(Lane& s, int& left, int sb, bool copy,
                                    int fe0, int fe1, int maxb,
                                    const double* smr, const double* smr00,
                                    const int* stp, const double* snr,
                                    const double* snr0, u64 klim) {
  const u64 kinf = flip(kInf);
  int steps = 0;
  for (;;) {
    const bool b = s.k1 < s.k0;   // the better channel, 0 on a tie
    const u64 kb = b ? s.k1 : s.k0;
    const unsigned hi = static_cast<unsigned>(kb >> 32);
    const unsigned lo = static_cast<unsigned>(kb);
    const unsigned mhi = __reduce_min_sync(kFull, hi);
    const unsigned mlo = __reduce_min_sync(kFull, hi == mhi ? lo : kFull);
    const u64 kmin = (static_cast<u64>(mhi) << 32) | mlo;
    if (kmin >= klim) break;   // the same in every lane
    // Every lane prices the step its better candidate would take, beside
    // the reduction; the winner's is kept.  A candidate that is not frozen
    // is below its maxba <= 15, and has taken no step exactly when its
    // allocation is 0 (the others' reads stay in the tables: the SNR
    // table has a 17th row).
    const int cur = b ? s.ba1 : s.ba0;
    const int total = stp[cur * 32] + (cur == 0 ? (b ? fe1 : fe0) : 0);
    const bool fits = left >= total;
    const int nb = cur + fits;
    const bool live = fits && nb < maxb;
    const double snr1 = snr[(cur + 1) * 32];
    const u64 kn = flip(snr1 - smr[b]);
    const u64 kt = live ? kn : kinf;
    const int win = __ffs(__ballot_sync(kFull, hi == mhi && lo == mlo)) - 1;
    // the bits taken
    const int taken = __shfl_sync(kFull, fits ? total : 0, win);
    ++steps;
    left -= taken;
    if (sb == win) {
      if (kCopy && copy) {
        const u64 ko = live ? flip(snr1 - smr[!b]) : kinf;
        s.k0 = b ? ko : kt;
        s.k1 = b ? kt : ko;
        s.ba0 = s.ba1 = nb;
      } else if (b) {
        s.k1 = kt;
        s.ba1 = nb;
      } else {
        s.k0 = kt;
        s.ba0 = nb;
      }
    }
    if (kLayer == 1 && win == 0) {   // the same in every lane
      // lane 0's channel-0 allocation moves on its taken step, or on
      // either outcome of its channel 1 when it copies: a new limit
      const int m = __shfl_sync(
          kFull, (b ? kCopy && copy : fits) ? s.ba0 : -1, 0);
      if (m >= 0) klim = limit_key(snr0[m * 32] - *smr00 + 1.0);
    }
  }
  return steps;
}

template <int kLayer>
__global__ void __launch_bounds__(kK5Warps * 32, kBlocksPerSM)
alloc12_kernel(const double* __restrict__ smr,
               const int32_t* __restrict__ scfsi,
               const double* __restrict__ dtab,
               const int32_t* __restrict__ itab, Params p,
               int32_t* __restrict__ ba_out, int32_t* __restrict__ left_out,
               int32_t* __restrict__ mode_out,
               int32_t* __restrict__ ext_out,
               int32_t* __restrict__ jsb_out,
               int32_t* __restrict__ steps_out) {
  // the greedy walk's tables stored [k][sb], so that lanes at one k read
  // other banks: snr_after in float64 (a 17th row that no step reads),
  // a step's sample bits from ba = k, cost[min(k + 1, 15)] -
  // (k ? cost[k] : 0), in int32 (every cost is an integer); maxba, nbal,
  // the ladder's bound, the jsbounds, 6 * SFS_PER_SCFSI; each warp's SMR,
  // [sb][ch].  The joint decision reads the ladder and the cost from dtab.
  __shared__ double s_snr[17 * 32], s_smr[kK5Warps][64];
  __shared__ int s_stp[512], s_int[kI + 4];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    const int k = i & 15, t = k * 32 + (i >> 4);
    const double* cost = dtab + 512 + (i - k);
    s_snr[t] = dtab[i];
    s_stp[t] = static_cast<int>(cost[k < 15 ? k + 1 : 15] -
                                (k ? cost[k] : 0.0));
  }
  for (int i = threadIdx.x; i < kI; i += blockDim.x) s_int[i] = itab[i];
  if (threadIdx.x < 32) s_snr[512 + threadIdx.x] = 0.0;
  if (threadIdx.x < 4)
    s_int[kI + threadIdx.x] = static_cast<int>(dtab[1536 + threadIdx.x]);
  __syncthreads();
  const int* maxba = s_int;
  const int* nbal = s_int + 32;
  const int* bound = s_int + 64;
  const int* jsb = s_int + 96;
  const int* sfs6 = s_int + kI;

  const int w = threadIdx.x >> 5;
  const int f = blockIdx.x * kK5Warps + w;
  if (f >= p.F) return;   // a whole warp leaves; no block barrier follows
  const int sb = threadIdx.x & 31;
  const long long base = static_cast<long long>(f) * 64;
  const double smr0 = smr[base + sb], smr1 = smr[base + 32 + sb];
  const int scf0 = kLayer == 2 ? scfsi[base + sb] : 0;
  const int scf1 = kLayer == 2 ? scfsi[base + 32 + sb] : 0;
  double* lsmr = s_smr[w] + 2 * sb;
  lsmr[0] = smr0;
  lsmr[1] = smr1;
  __syncwarp();

  // ---- the joint decision (runtime/alloc12.py joint_mode)
  const int full = kLayer == 1 ? 32 : p.sblimit;
  int jsbound = full, mode_ext = 0, mode = p.mode;
  if (p.joint) {
    const double* lad = dtab + 1024 + sb * 16;
    const double* cost = dtab + 512 + sb * 16;
    const int k0 = rung_g(lad, bound[sb], smr0);
    const int k1 = rung_g(lad, bound[sb], smr1);
    const bool needs = __reduce_add_sync(
        kFull, nonoise_bits<kLayer>(sb, full, k0, k1, scf0, scf1, cost,
                                    sfs6, nbal, p)) > p.adb;
    mode = needs ? p.mode_joint : p.mode_stereo;
    if (needs) {
      for (int ext = 3; ext >= 0; --ext) {
        const int jb = jsb[ext];
        mode_ext = ext;
        jsbound = jb;
        if (!(__reduce_add_sync(
                  kFull, nonoise_bits<kLayer>(sb, jb, k0, k1, scf0, scf1,
                                              cost, sfs6, nbal, p)) >
              p.adb))
          break;
      }
    }
  }

  // ---- the greedy allocation (runtime/alloc12.py greedy_allocation)
  const bool js = sb >= jsbound;
  const bool copy = p.nch == 2 && js;   // a step copies to the other channel
  const int sbl = kLayer == 1 ? 32 : p.sblimit;
  const int bbal =
      kLayer == 1 ? 4 * (jsbound * p.nch + (32 - jsbound))
                  : __reduce_add_sync(
                        kFull, sb < sbl ? nbal[sb] * (js ? 1 : p.nch) : 0);
  // the bits left: ad less every step's bits taken so far
  int left = p.adb - bbal - (p.ep ? 16 : 0) - 32;
  // a channel's first step adds Layer I's scale factors, Layer II's
  // selection and scale-factor bits (of both channels when it copies)
  int fe0, fe1;
  if (kLayer == 1) {
    fe0 = fe1 = 6 * (js ? p.nch : 1);
  } else {
    const int a = sfs6[scf0], b = sfs6[scf1];
    fe0 = 2 + a + (copy ? 2 + b : 0);
    fe1 = 2 + b + (copy ? 2 + a : 0);
  }
  const u64 kinf = flip(kInf);
  Lane s;
  s.k0 = sb < sbl ? order_key(-smr0) : kinf;
  s.k1 = sb < sbl && p.nch == 2 ? order_key(-smr1) : kinf;
  s.ba0 = s.ba1 = 0;
  // Layer I's limit, from mnr[0][0] = -smr[0][0]
  const double* smr00 = s_smr[w];
  const u64 klim = kLayer == 1 ? limit_key(-*smr00 + 1.0) : kinf;
  // A NaN candidate (key 0) is the first step's argmin and ends the frame
  // there; no step makes a NaN, so the walk's exit reads only the limit
  const bool nan = __any_sync(kFull, s.k0 == 0 || s.k1 == 0);
  const int steps =
      nan ? 0
      : p.nch == 2 && jsbound < sbl
          ? walk<kLayer, true>(s, left, sb, copy, fe0, fe1, maxba[sb], lsmr,
                               smr00, s_stp + sb, s_snr + sb, s_snr, klim)
          : walk<kLayer, false>(s, left, sb, copy, fe0, fe1, maxba[sb],
                                lsmr, smr00, s_stp + sb, s_snr + sb, s_snr,
                                klim);
  ba_out[base + sb] = s.ba0;
  ba_out[base + 32 + sb] = s.ba1;
  if (sb == 0) {
    left_out[f] = left;
    mode_out[f] = mode;
    ext_out[f] = mode_ext;
    jsb_out[f] = jsbound;
    steps_out[f] = steps;
  }
}

template <int kLayer>
void prefer_shared() {
  // 16 blocks of 8.7 KB of tables each: ask for the largest shared memory
  // carveout, once
  static const cudaError_t done = cudaFuncSetAttribute(
      alloc12_kernel<kLayer>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  (void)done;
}

}  // namespace

// K5 over F frames on `stream`: smr (F, 2, 32) float64 (channel 1 a copy of
// channel 0 for mono), scfsi (F, 2, 32) int32 or null (Layer I), the tables
// of ops/alloc12.py; writes ba (F, 2, 32), adb_left, mode, mode_ext,
// jsbound and the greedy steps (F,) int32.  Returns the launch's CUDA
// error (0 on success).
extern "C" int mp3_alloc12(const void* smr, const void* scfsi,
                           const void* dtab, const void* itab, int F,
                           int layer, int nch, int sblimit, int adb, int ep,
                           int joint, int mode, int mode_joint,
                           int mode_stereo, void* ba, void* adb_left,
                           void* mode_out, void* mode_ext, void* jsbound,
                           void* steps, void* stream) {
  if (F <= 0) return 0;
  if ((layer != 1 && layer != 2) || (nch != 1 && nch != 2) || sblimit < 1 ||
      sblimit > 32)
    return cudaErrorInvalidValue;
  Params p{F, layer, nch, sblimit, adb, ep, joint, mode, mode_joint,
           mode_stereo};
  const int blocks = (F + kK5Warps - 1) / kK5Warps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* sm = static_cast<const double*>(smr);
  const int32_t* sc = static_cast<const int32_t*>(scfsi);
  const double* dt = static_cast<const double*>(dtab);
  const int32_t* it = static_cast<const int32_t*>(itab);
  int32_t* o[6] = {static_cast<int32_t*>(ba), static_cast<int32_t*>(adb_left),
                   static_cast<int32_t*>(mode_out),
                   static_cast<int32_t*>(mode_ext),
                   static_cast<int32_t*>(jsbound),
                   static_cast<int32_t*>(steps)};
  if (layer == 1) {
    prefer_shared<1>();
    alloc12_kernel<1><<<blocks, kK5Warps * 32, 0, s>>>(
        sm, sc, dt, it, p, o[0], o[1], o[2], o[3], o[4], o[5]);
  } else {
    prefer_shared<2>();
    alloc12_kernel<2><<<blocks, kK5Warps * 32, 0, s>>>(
        sm, sc, dt, it, p, o[0], o[1], o[2], o[3], o[4], o[5]);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K5 of `layer` that an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); writes K5's warps
// (frames) a block to *warps_per_block.  A negative CUDA error on failure.
extern "C" int mp3_alloc12_occupancy(int layer, int* warps_per_block) {
  int n = 0;
  cudaError_t e;
  *warps_per_block = kK5Warps;
  if (layer == 1) {
    prefer_shared<1>();
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, alloc12_kernel<1>, kK5Warps * 32, 0);
  } else {
    prefer_shared<2>();
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, alloc12_kernel<2>, kK5Warps * 32, 0);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
