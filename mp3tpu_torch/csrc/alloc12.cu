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
// and 2i + 1 of the reference's sb-outer, ch-inner scan.  A greedy step:
//   1. each lane offers the better of its two candidates, then five
//      __shfl_xor_sync rounds reduce (value, index) pairs to numpy's argmin:
//      the first NaN if any lane holds one, else the first smallest value
//      (a non-candidate carries INF = 1e30; an SMR of -inf gives mnr = +inf,
//      which loses even to INF);
//   2. the frame ends unless the value is below the limit (Layer I: the
//      current mnr[0][0] + 1, re-read each step; Layer II: INF; a NaN
//      limit ends it too -- numpy's minimum propagates NaN, fmin would not);
//   3. the winning lane prices the step (Layer II's cost gather clamped at
//      min(cur + 1, 15)), tests the fit against the frame's running sums,
//      takes or freezes, and copies the joint channel above jsbound on
//      either outcome; it broadcasts the fit and the three increments, and
//      every lane adds them to its copy of the running sums.
// Everything is float64 in the reference's order of operations, built with
// -fmad=false (the sums are integer-valued and exact in any order; the mnr
// update -smr + snr is one rounding either way).
//
// The joint decision evaluates bits_for_nonoise at the full bound and then
// at each mode_ext's jsbound (3, 2, 1, 0) until one fits: each lane finds
// its subband's rung on the SNR ladder by a linear search of at most 15
// entries (the ladders are ascending, so the search returns numpy's
// searchsorted(side="left"); a NaN SMR sorts last), and a warp sum adds the
// lanes' bits.
//
// What bounds it: the chain of dependent steps of the longest frame, about
// 5 shuffle rounds and the winner's fit each (chip_smoke.py
// k5_step_cycles); the bytes (the SMR in float64, the scfsi and the
// outputs) are ~1.4 MB on a 60 s stereo clip, under a microsecond at the
// HBM rate.  The frames run in parallel, 8 warps a block, so the design is
// latency-bound: the card holds every frame of a clip resident at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o liballoc12.so alloc12.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
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

// is (av, ai) before (bv, bi) in numpy's argmin: NaN first, then the
// smaller value, then the smaller index
__device__ __forceinline__ bool before(double av, int ai, double bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && bn ? ai < bi : an;
  if (av < bv) return true;
  if (bv < av) return false;
  return ai < bi;
}

__device__ __forceinline__ double sum_warp(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// searchsorted(ladder[sb][:bound], x, side="left") on an ascending ladder
__device__ __forceinline__ int rung(const double* lad, int bound, double x) {
  int k = 0;
  if (bound > 0)
    while (k < bound && (lad[k] < x || x != x)) ++k;
  return k;
}

// bits_for_nonoise (runtime/alloc12.py:41) of this lane's subband at
// jsbound jb; the warp's sum is the frame's requirement
__device__ __forceinline__ double nonoise_lane(
    int sb, int jb, int k0, int k1, int scf0, int scf1, const double* cost,
    const double* sfs6, const int* nbal, const Params& p) {
  const bool js = sb >= jb;
  const bool both = p.nch == 2 && js;
  const int ke0 = both ? (k0 > k1 ? k0 : k1) : k0;
  double req = 0.0;
  if (p.layer == 1) {
    const int per0 = ke0 > 0 ? (ke0 + 1) * 12 + 6 * (js ? p.nch : 1) : 0;
    const int per1 = k1 > 0 ? (k1 + 1) * 12 + 6 : 0;
    req = per0 + ((p.nch == 2 && !js) ? per1 : 0);
    if (sb == 0) req += 32 + 4 * (jb * p.nch + (32 - jb));
    return req;
  }
  const bool in_range = sb < p.sblimit;
  const double sel = 2.0 + (both ? 2.0 : 0.0);
  const double sc0 = sfs6[scf0] + (both ? sfs6[scf1] : 0.0);
  const double sc1 = sfs6[scf1] + (both ? sfs6[scf0] : 0.0);
  const double per0 = ke0 > 0 ? cost[sb * 16 + ke0] + sel + sc0 : 0.0;
  const double per1 = k1 > 0 ? cost[sb * 16 + k1] + sel + sc1 : 0.0;
  if (in_range) {
    req = per0 + ((p.nch == 2 && !js) ? per1 : 0.0);
    req += nbal[sb] * (js ? 1 : p.nch);
  }
  if (sb == 0) req += 32 + (p.ep ? 16 : 0);
  return req;
}

__global__ void __launch_bounds__(kWarps * 32)
alloc12_kernel(const double* __restrict__ smr,
               const int32_t* __restrict__ scfsi,
               const double* __restrict__ dtab,
               const int32_t* __restrict__ itab, Params p,
               int32_t* __restrict__ ba_out, int32_t* __restrict__ left_out,
               int32_t* __restrict__ mode_out,
               int32_t* __restrict__ ext_out,
               int32_t* __restrict__ jsb_out,
               int32_t* __restrict__ steps_out) {
  __shared__ double sd[kD];
  __shared__ int si[kI];
  for (int i = threadIdx.x; i < kD; i += blockDim.x) sd[i] = dtab[i];
  for (int i = threadIdx.x; i < kI; i += blockDim.x) si[i] = itab[i];
  __syncthreads();
  const double* snr_after = sd;
  const double* cost = sd + 512;
  const double* ladder = sd + 1024;
  const double* sfs6 = sd + 1536;
  const int* maxba = si;
  const int* nbal = si + 32;
  const int* bound = si + 64;
  const int* jsb = si + 96;

  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f >= p.F) return;   // a whole warp leaves; no block barrier follows
  const int sb = threadIdx.x & 31;
  const long long base = static_cast<long long>(f) * 64;
  const double smr0 = smr[base + sb], smr1 = smr[base + 32 + sb];
  const int scf0 = scfsi ? scfsi[base + sb] : 0;
  const int scf1 = scfsi ? scfsi[base + 32 + sb] : 0;

  // ---- the joint decision (runtime/alloc12.py joint_mode)
  const int full = p.layer == 1 ? 32 : p.sblimit;
  int jsbound = full, mode_ext = 0, mode = p.mode;
  if (p.joint) {
    const int k0 = rung(ladder + sb * 16, bound[sb], smr0);
    const int k1 = rung(ladder + sb * 16, bound[sb], smr1);
    const double req = sum_warp(
        nonoise_lane(sb, full, k0, k1, scf0, scf1, cost, sfs6, nbal, p));
    const bool needs = req > static_cast<double>(p.adb);
    mode = needs ? p.mode_joint : p.mode_stereo;
    if (needs) {
      for (int ext = 3; ext >= 0; --ext) {
        const int jb = jsb[ext];
        mode_ext = ext;
        jsbound = jb;
        const double r = sum_warp(
            nonoise_lane(sb, jb, k0, k1, scf0, scf1, cost, sfs6, nbal, p));
        if (!(r > static_cast<double>(p.adb))) break;
      }
    }
  }

  // ---- the greedy allocation (runtime/alloc12.py greedy_allocation)
  const bool js = sb >= jsbound;
  const int sbl = p.layer == 1 ? 32 : p.sblimit;
  long long bbal;
  if (p.layer == 1) {
    bbal = 4LL * (jsbound * p.nch + (32 - jsbound));
  } else {
    int lane = sb < sbl ? nbal[sb] * (js ? 1 : p.nch) : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) lane += __shfl_xor_sync(kFull, lane, o);
    bbal = lane;
  }
  const long long ad = static_cast<long long>(p.adb) - bbal -
                       (p.ep ? 16 : 0) - 32;
  const double adf = static_cast<double>(ad);
  double mnr[2] = {-smr0, -smr1};
  const double smrs[2] = {smr0, smr1};
  const double sc6[2] = {p.layer == 2 ? sfs6[scf0] : 0.0,
                         p.layer == 2 ? sfs6[scf1] : 0.0};
  int used[2] = {0, 0}, ba[2] = {0, 0};
  const bool ok[2] = {sb < sbl, sb < sbl && p.nch == 2};
  double bspl = 0.0, bscf = 0.0, bsel = 0.0;
  int steps = 0;
  for (;;) {
    const double c0 = (used[0] != 2 && ok[0]) ? mnr[0] : kInf;
    const double c1 = (used[1] != 2 && ok[1]) ? mnr[1] : kInf;
    double v = c0;
    int idx = 2 * sb;
    if (before(c1, 2 * sb + 1, v, idx)) {
      v = c1;
      idx = 2 * sb + 1;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, v, o);
      const int oi = __shfl_xor_sync(kFull, idx, o);
      if (before(ov, oi, v, idx)) {
        v = ov;
        idx = oi;
      }
    }
    double lim = kInf;
    if (p.layer == 1) {
      const double l = __shfl_sync(kFull, mnr[0], 0) + 1.0;
      lim = (l != l) ? l : (l < kInf ? l : kInf);   // np.minimum(l, INF)
    }
    if (!(v < lim)) break;   // uniform: every lane holds the same v, lim
    ++steps;
    const int psb = idx >> 1, pch = idx & 1;
    int fits = 0;
    double inc = 0.0, scale = 0.0, seli = 0.0;
    if (sb == psb) {
      const int cur = ba[pch];
      const bool first = used[pch] == 0;
      if (p.layer == 1) {
        inc = first ? 24.0 : 12.0;
        scale = first ? 6.0 : 0.0;
        scale = scale * static_cast<double>(js ? p.nch : 1);
      } else {
        const double nxt = cost[sb * 16 + (cur + 1 < 15 ? cur + 1 : 15)];
        inc = nxt - (first ? 0.0 : cost[sb * 16 + cur]);
        seli = first ? 2.0 : 0.0;
        scale = first ? sc6[pch] : 0.0;
        if (p.nch == 2) {
          const bool extra = js && first;
          seli = seli + (extra ? 2.0 : 0.0);
          scale = scale + (extra ? sc6[1 - pch] : 0.0);
        }
      }
      fits = adf >= bspl + bscf + bsel + seli + scale + inc;
      if (fits) {
        ba[pch] += 1;
        used[pch] = 1;
        mnr[pch] = -smrs[pch] + snr_after[sb * 16 + ba[pch]];
        if (ba[pch] >= maxba[sb]) used[pch] = 2;
      } else {
        used[pch] = 2;
      }
      if (p.nch == 2 && js) {
        const int o = 1 - pch;
        ba[o] = ba[pch];
        used[o] = used[pch];
        mnr[o] = -smrs[o] + snr_after[sb * 16 + ba[o]];
      }
    }
    fits = __shfl_sync(kFull, fits, psb);
    inc = __shfl_sync(kFull, inc, psb);
    scale = __shfl_sync(kFull, scale, psb);
    seli = __shfl_sync(kFull, seli, psb);
    if (fits) {
      bspl += inc;
      bscf += scale;
      bsel += seli;
    }
  }
  if (p.layer == 2 && sb >= p.sblimit) ba[0] = ba[1] = 0;
  ba_out[base + sb] = ba[0];
  ba_out[base + 32 + sb] = ba[1];
  if (sb == 0) {
    left_out[f] = static_cast<int32_t>(
        static_cast<long long>(adf - bspl - bscf - bsel));
    mode_out[f] = mode;
    ext_out[f] = mode_ext;
    jsb_out[f] = jsbound;
    steps_out[f] = steps;
  }
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
  const int blocks = (F + kWarps - 1) / kWarps;
  alloc12_kernel<<<blocks, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(smr), static_cast<const int32_t*>(scfsi),
      static_cast<const double*>(dtab), static_cast<const int32_t*>(itab), p,
      static_cast<int32_t*>(ba), static_cast<int32_t*>(adb_left),
      static_cast<int32_t*>(mode_out), static_cast<int32_t*>(mode_ext),
      static_cast<int32_t*>(jsbound), static_cast<int32_t*>(steps));
  return static_cast<int>(cudaGetLastError());
}
