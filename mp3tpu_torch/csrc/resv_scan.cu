// Bit-reservoir budget scan (K4) for Hopper: chunk maps built in parallel,
// composed, then re-walked.
//
// Replaces the device loop of the JAX package's reservoir scan,
// mp3tpu/ops/jaxresv.py:_scan_core (a lax.scan over frames inside the
// compiled segment program; vmapped over clips by the corpus path,
// mp3tpu/parallel/corpus.py:_plan_budgets_corpus).  Per granule, in
// granule-major order r = gr*nch + ch (reservoir.c:101-134):
//   more_bits = trunc(pe*3.1 - mean)                      (in double)
//   add       = more_bits > 100 ? min(6*size/10, more_bits) : 0
//   over      = size - 8*resv_max/10 - add;  add += max(over, 0)
//   budget    = min(max_bits + add, 4095)    (max_bits when resv_max == 0)
//   used      = demand < budget ? demand : max(budget - delta, 0)
//   size     += mean - used
// and per frame: +1 for stereo at an odd mean_bits, clamp to resv_max,
// round down to a multiple of 8; a frame whose `valid` byte is 0 (bucket
// padding) gets its budgets from the carried level and leaves the level
// as it was.  Its plain version is the native host scan
// (csrc/mp3bits.cpp mp3resv_scan, mode 0, through ops/resv.py), whose
// integer arithmetic this kernel repeats operation for operation, C
// division and remainder included.
//
// pe arrives as float32 and is widened to double before the multiply,
// as the host scan reads it: trunc(pe*3.1) in float32 can move a budget
// by one bit (jaxresv.py:17-20).  The multiply and the subtraction are
// separate roundings (__dmul_rn, __dsub_rn), never one FMA.  A value
// outside the 64-bit range converts as x86-64's cvttsd2si converts it
// (to the most negative integer), as the native scan does on the host;
// pe is finite and far below that on every path (the analysis guard
// zeroes a non-finite pe).
//
// What makes the carry parallel: the level at a frame's end takes few
// values.  Within a granule 0 <= add <= size and used <= budget <=
// max_bits + add <= mean + add, so a level >= 0 stays >= 0; the frame's
// end clamps it to resv_max and rounds it down to a multiple of 8.  So
// after any real frame the level is one of the S = resv_max/8 + 1 states
// 8*s (s < S) -- 512 for MPEG-1, 256 for LSF.  A leading run of padded
// frames passes size0 itself through, and size0 may lie off that domain,
// so a map has one more state, index S: "the level is still size0".
//
// The design, two kernels a call on the caller's stream:
//  1. resv_map_kernel, one block a (clip, chunk of C frames but the last,
//     group of the chunk's states): the block stages the chunk's
//     more_bits (the only double arithmetic), demand and valid flags in
//     shared memory, then thread s walks the chunk from state s and
//     writes the state it ends in (uint16) to maps[clip][chunk][s].  The
//     first chunk starts at size0 and needs only state S.  A chunk's
//     states are split among as many blocks as fill the SMs.
//  2. resv_walk_kernel, one block a clip: the block copies the clip's
//     maps into shared memory and stages the chunks' inputs there (at an
//     odd stride, free of bank conflicts), one thread follows the chunk
//     starts through the maps (start[k+1] = maps[k][start[k]]: K - 1
//     dependent shared-memory loads), then thread k re-walks chunk k
//     from its start, each budget replacing its more_bits, and the block
//     writes the budgets out coalesced; the last chunk's thread writes
//     size_out.  Chunks that do not fit the staging area at once go in
//     passes; one chunk wider than all of it walks in device memory.
// The host picks C (ops/resv.py chunk_frames) so that (K - 1)(S + 1)
// map entries fit the walk block's shared memory.  A level off the
// domain that is not size0 cannot follow a real frame unless size0 < 0
// or delta < 0 (never on any path); the composing thread then walks that
// chunk itself, so every input scans exactly as the host does.
//
// What bounds it: the map build does S + 1 times the serial scan's work
// -- B*F*R*(S+1) granule steps of ~14 int32 operations, ~20 instructions
// -- to cut the carry chain to two walks of C*R granules and K - 1
// lookups.  At the main path's 4096-lane segment (F = 1024, R = 4, S + 1
// = 513) that is 2.1 M steps, a few microseconds at the card's int32
// rate, and the chain about as long; for a corpus group of 16 clips the
// 14.1 M steps bound it.  The bytes (16 a granule) are under a
// microsecond.  chunk_frames balances the walks against the lookups;
// the states of a chunk read one staged copy of its inputs (shared-memory
// broadcasts), so the map build costs no more bytes than the scan.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libresv_scan.so
//        resv_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// granules a map-build block stages per pass: 2 int arrays + the frames'
// flags, 24 KB of static shared memory
constexpr int kTile = 2048;
// states a map holds at most: one map-build thread each
constexpr int kMaxStates = 1024;
// chunks a clip at most: one re-walk thread each
constexpr int kMaxChunks = 1024;
constexpr int kWalkThreads = 1024;
// dynamic shared memory of the walk block: a clip's maps (at most
// kMapSmem of it) and the staged chunks of a pass
constexpr int kWalkSmem = 221184;
constexpr int kMapSmem = 196608;
// a map entry for a level off the domain that is not size0
constexpr uint16_t kUnknown = 0xFFFF;

struct Scan {
  int R, mean, max_bits, resv_max, cap, delta, odd, S;
};

// more_bits from one granule's pe, as the native scan computes
// (long)(pe * 3.1 - (double)mean) on x86-64, then held in [-1e9, 1e9]:
// the recurrence only compares it with 100 and with 6*size/10, so the
// clamp changes no budget.
__device__ __forceinline__ int more_bits_of(float pe, int mean) {
  const double m = __dsub_rn(__dmul_rn(static_cast<double>(pe), 3.1),
                             static_cast<double>(mean));
  long long t = INT64_MIN;                    // out of range or NaN
  if (m >= -9223372036854775808.0 && m < 9223372036854775808.0)
    t = static_cast<long long>(m);            // truncates toward zero
  if (t > 1000000000LL) t = 1000000000LL;
  if (t < -1000000000LL) t = -1000000000LL;
  return static_cast<int>(t);
}

// one granule's budget at level `size` (mp3bits.cpp mp3resv_scan, mode 0)
__device__ __forceinline__ int budget_of(int size, int more, const Scan& p) {
  if (p.resv_max == 0) return p.max_bits;
  int add = 0;
  if (more > 100) {
    const int frac = (size * 6) / 10;
    add = frac < more ? frac : more;
  }
  const int over = size - p.cap - add;
  if (over > 0) add += over;
  const int b = p.max_bits + add;
  return b > 4095 ? 4095 : b;
}

// the level after a granule of budget b and demand dem
__device__ __forceinline__ int level_after(int size, int b, int dem,
                                           const Scan& p) {
  int used = dem < b ? dem : b - p.delta;
  if (used < 0) used = 0;
  return size + p.mean - used;
}

// the frame's end: the odd-mean add, the clamp, the rounding to 8
__device__ __forceinline__ int frame_end(int size, const Scan& p) {
  if (p.odd) size += 1;
  if (size > p.resv_max) size = p.resv_max;
  return size - size % 8;
}

// the state of a level: 8*s on the domain -> s, size0 -> S, else none
__device__ __forceinline__ int state_of(int size, int size0, const Scan& p) {
  if (size >= 0 && size <= p.resv_max && size % 8 == 0) return size / 8;
  return size == size0 ? p.S : -1;
}

// frames [f0, f1) of one clip walked from `size` in device memory, their
// budgets written when `bud` is given; returns the level after them.  The
// slow path: the composition's walk off the domain, and a chunk wider
// than the walk block's staging area
__device__ __forceinline__ int walk(const float* pe, const int* dem,
                                    const uint8_t* val, int f0, int f1,
                                    int size, const Scan& p, int* bud) {
  for (int f = f0; f < f1; ++f) {
    const int size_in = size;
    const long long g = static_cast<long long>(f) * p.R;
    for (int r = 0; r < p.R; ++r) {
      const int b = budget_of(size, more_bits_of(pe[g + r], p.mean), p);
      if (bud) bud[g + r] = b;
      size = level_after(size, b, dem[g + r], p);
    }
    size = frame_end(size, p);
    // a padded frame leaves the level as it found it
    if (val && !val[f]) size = size_in;
  }
  return size;
}

// nf staged frames walked from `size`: more_bits and demand at i = f*R +
// r, the frames' flags at f; with kWrite each budget replaces its
// more_bits.  RT: the granules of a frame, known at compile time (the
// frame's granules unrolled), or 0 (p.R at run time)
template <int RT, bool kWrite>
__device__ __forceinline__ int walk_staged(int size, int* more,
                                           const int* dem, const int* val,
                                           int nf, const Scan& p) {
  const int R = RT ? RT : p.R;
  for (int f = 0; f < nf; ++f) {
    const int size_in = size;
    if constexpr (RT > 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int b = budget_of(size, more[f * RT + r], p);
        if (kWrite) more[f * RT + r] = b;
        size = level_after(size, b, dem[f * RT + r], p);
      }
    } else {
      for (int r = 0; r < R; ++r) {
        const int b = budget_of(size, more[f * R + r], p);
        if (kWrite) more[f * R + r] = b;
        size = level_after(size, b, dem[f * R + r], p);
      }
    }
    size = frame_end(size, p);
    if (!val[f]) size = size_in;
  }
  return size;
}

template <int RT>
__global__ void __launch_bounds__(kMaxStates)
resv_map_kernel(const float* __restrict__ pe,
                const int* __restrict__ demand,
                const uint8_t* __restrict__ valid, int valid_stride,
                const int* __restrict__ size0, int F, int C, int K,
                int groups, Scan p, int map_words,
                uint16_t* __restrict__ maps) {
  __shared__ int s_more[kTile];
  __shared__ int s_dem[kTile];
  __shared__ int s_val[kTile];

  // block = (clip, chunk k < K - 1, group g of the chunk's states)
  const int g = blockIdx.x % groups;
  const int k = blockIdx.x / groups % (K - 1);
  const int clip = blockIdx.x / groups / (K - 1);
  const int s = g * blockDim.x + threadIdx.x;
  // the first chunk starts at size0: only state S walks it
  if (k == 0 && p.S / blockDim.x != g) return;
  const bool live = s <= p.S && (k > 0 || s == p.S);
  const int R = RT ? RT : p.R;
  const long long n = static_cast<long long>(F) * R;
  const float* pe_c = pe + clip * n;
  const int* dem_c = demand + clip * n;
  const uint8_t* val_c =
      valid ? valid + static_cast<long long>(clip) * valid_stride : nullptr;
  const int s0 = size0[clip];
  int size = s == p.S ? s0 : 8 * s;
  const int f_end = (k + 1) * C;                // k < K - 1: inside F
  const int frames_per_tile = kTile / R;

  for (int f0 = k * C; f0 < f_end; f0 += frames_per_tile) {
    const int nf = min(frames_per_tile, f_end - f0);
    const int ng = nf * R;
    const long long g0 = static_cast<long long>(f0) * R;
    // stage the tile: everything that does not depend on the level
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      s_more[i] = more_bits_of(pe_c[g0 + i], p.mean);
      s_dem[i] = dem_c[g0 + i];
    }
    for (int i = threadIdx.x; i < nf; i += blockDim.x)
      s_val[i] = val_c ? val_c[f0 + i] : 1;
    __syncthreads();
    if (live) size = walk_staged<RT, false>(size, s_more, s_dem, s_val, nf, p);
    __syncthreads();          // the tile's shared arrays are free again
  }
  if (live) {
    const int e = state_of(size, s0, p);
    maps[clip * static_cast<long long>(map_words) +
         static_cast<long long>(k) * (p.S + 1) + s] =
        e < 0 ? kUnknown : static_cast<uint16_t>(e);
  }
}

// the chunk starts from chunk k on, whose start s_start[k] lies off the
// domain (a negative size0 or delta): lookups where the level has a
// state, else the chunk walked in device memory
__device__ __forceinline__ void compose_off_domain(
    int k, int K, int C, int s0, const Scan& p, const uint16_t* s_maps,
    int* s_start, const float* pe, const int* dem, const uint8_t* val) {
  for (; k + 1 < K; ++k) {
    const int size = s_start[k];
    const int state = state_of(size, s0, p);
    const int next = state < 0 ? kUnknown : s_maps[k * (p.S + 1) + state];
    s_start[k + 1] = next == kUnknown
        ? walk(pe, dem, val, k * C, (k + 1) * C, size, p, nullptr)
        : next < p.S ? 8 * next : s0;
  }
}

template <int RT>
__global__ void __launch_bounds__(kWalkThreads)
resv_walk_kernel(const float* __restrict__ pe,
                 const int* __restrict__ demand,
                 const uint8_t* __restrict__ valid, int valid_stride,
                 const int* __restrict__ size0, int F, int C, int K, Scan p,
                 int map_words, const uint16_t* __restrict__ maps,
                 int per_pass, int* __restrict__ budgets,
                 int* __restrict__ size_out) {
  // dynamic shared memory: the clip's maps (map_words uint16), then the
  // staged chunks of a pass: more_bits (then the budgets) and demand at
  // an odd stride P a chunk, the frames' flags at an odd stride Cp
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_start[kMaxChunks];
  const uint16_t* s_maps = reinterpret_cast<const uint16_t*>(s_dyn);
  const int R = RT ? RT : p.R;
  const int CR = C * R;
  const int P = CR | 1, Cp = C | 1;           // odd: no bank conflicts
  int* s_more = reinterpret_cast<int*>(s_dyn + 2 * map_words);
  int* s_dem = s_more + per_pass * P;
  int* s_val = s_dem + per_pass * P;

  const int clip = blockIdx.x;
  const long long n = static_cast<long long>(F) * R;
  const float* pe_c = pe + clip * n;
  const int* dem_c = demand + clip * n;
  int* bud_c = budgets + clip * n;
  const uint8_t* val_c =
      valid ? valid + static_cast<long long>(clip) * valid_stride : nullptr;
  const int s0 = size0[clip];

  // stage chunks [k0, k1): more_bits and demand in parallel, coalesced
  auto stage = [&](int k0, int k1) {
    const int g1 = min(F, k1 * C) * R;
    for (int g = k0 * CR + threadIdx.x; g < g1; g += blockDim.x) {
      const int j = g / CR - k0, i = g % CR;
      s_more[j * P + i] = more_bits_of(pe_c[g], p.mean);
      s_dem[j * P + i] = dem_c[g];
    }
    for (int f = k0 * C + threadIdx.x; f < min(F, k1 * C); f += blockDim.x)
      s_val[(f / C - k0) * Cp + f % C] = val_c ? val_c[f] : 1;
  };

  // the clip's maps (map_words: a multiple of 8) and the first pass
  const uint4* src = reinterpret_cast<const uint4*>(
      maps + clip * static_cast<long long>(map_words));
  uint4* dst = reinterpret_cast<uint4*>(s_dyn);
  for (int i = threadIdx.x; i < map_words / 8; i += blockDim.x)
    dst[i] = src[i];
  if (per_pass) stage(0, min(K, per_pass));
  __syncthreads();
  if (threadIdx.x == 0) {
    // the chunk starts, in order: one dependent shared-memory load a
    // chunk while the level has a state
    const int S = p.S, S1 = S + 1;
    const uint16_t* row = s_maps;
    int state = S, k = 0;
    for (; k + 1 < K; ++k, row += S1) {
      s_start[k] = state < S ? 8 * state : s0;
      const int next = row[state];
      if (next == kUnknown) break;
      state = next;
    }
    s_start[k] = state < S ? 8 * state : s0;
    if (k + 1 < K)
      compose_off_domain(k, K, C, s0, p, s_maps, s_start, pe_c, dem_c,
                         val_c);
  }
  __syncthreads();
  if (!per_pass) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int size = walk(pe_c, dem_c, val_c, k * C, min(F, (k + 1) * C),
                            s_start[k], p, bud_c);
      if (k == K - 1) size_out[clip] = size;
    }
    return;
  }
  for (int k0 = 0; k0 < K; k0 += per_pass) {
    const int k1 = min(K, k0 + per_pass);
    if (k0) {
      stage(k0, k1);
      __syncthreads();
    }
    const int k = k0 + threadIdx.x;
    if (k < k1) {
      // chunk k from its start; each budget replaces its more_bits
      const int size = walk_staged<RT, true>(
          s_start[k], s_more + threadIdx.x * P, s_dem + threadIdx.x * P,
          s_val + threadIdx.x * Cp, min(F, (k + 1) * C) - k * C, p);
      if (k == K - 1) size_out[clip] = size;
    }
    __syncthreads();
    // the pass's budgets out, coalesced
    const int g1 = min(F, k1 * C) * R;
    for (int g = k0 * CR + threadIdx.x; g < g1; g += blockDim.x)
      bud_c[g] = s_more[(g / CR - k0) * P + g % CR];
    __syncthreads();
  }
}

// the two kernels at RT granules a frame (0: any)
template <int RT>
int launch(const float* pe, const int* dem, const uint8_t* val,
           int valid_stride, const int* s0, int B, int F, int C, int K,
           int groups, const Scan& p, int map_words, uint16_t* maps,
           int per_pass, int smem, int* budgets, int* size_out,
           cudaStream_t st) {
  if (K > 1) {
    const int S1 = p.S + 1;
    const int threads = ((S1 + groups - 1) / groups + 31) / 32 * 32;
    const int g = (S1 + threads - 1) / threads;
    resv_map_kernel<RT><<<B * (K - 1) * g, threads, 0, st>>>(
        pe, dem, val, valid_stride, s0, F, C, K, g, p, map_words, maps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // above 48 KB of shared memory in all only by the opt-in attribute
  if (smem + kMaxChunks * 4 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resv_walk_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWalkSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resv_walk_kernel<RT><<<B, kWalkThreads, smem, st>>>(
      pe, dem, val, valid_stride, s0, F, C, K, p, map_words, maps, per_pass,
      budgets, size_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B clips of F frames: pe (B, F, R) float32, demand (B, F, R) int32,
// valid NULL (every frame real) or uint8 flags with `valid_stride` bytes
// from one clip's to the next (0: one (F,) row for every clip), size0
// (B,) int32; budgets (B, F, R) int32 and size_out (B,) int32 out, with
// R = mode_gr * nch <= kTile.  `chunk` frames a chunk (C >= 1; K =
// ceil(F / C) chunks, at least 1) and `groups` blocks a chunk's map (its
// states split among them); `maps` a workspace of B * map_words uint16,
// map_words = (K - 1) * (resv_max/8 + 2) rounded up to a multiple of 8,
// 16-byte aligned (unused when K == 1).  Queues the map build (when
// K > 1) and the walk on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a chunk the kernels cannot take: a refused
// launch never runs.
extern "C" int mp3_resv_scan(const void* pe, const void* demand,
                             const void* valid, int valid_stride,
                             const void* size0, int B, int F, int nch,
                             int mode_gr, int mean_bits, int resv_max,
                             int delta, int chunk, int groups, void* maps,
                             void* budgets, void* size_out, void* stream) {
  if (B <= 0) return 0;
  Scan p;
  p.R = mode_gr * nch;
  p.mean = mean_bits / nch;
  p.max_bits = p.mean < 4095 ? p.mean : 4095;
  p.resv_max = resv_max;
  p.cap = (resv_max * 8) / 10;
  p.delta = delta;
  p.odd = nch == 2 && (mean_bits & 1);
  p.S = (resv_max > 0 ? resv_max : 0) / 8 + 1;
  const int C = chunk, S1 = p.S + 1;
  if (C < 1 || p.R < 1 || p.R > kTile || groups < 1)
    return cudaErrorInvalidValue;
  const int K = F > 0 ? (F + C - 1) / C : 1;
  const long long words = (static_cast<long long>(K - 1) * S1 + 7) / 8 * 8;
  if (K > kMaxChunks ||
      (K > 1 && (S1 > kMaxStates || 2 * words > kMapSmem)))
    return cudaErrorInvalidValue;
  const int map_words = static_cast<int>(words);
  // the walk's passes: as many chunks as the rest of its shared memory
  // stages (more_bits and demand at an odd stride, the flags), or none
  // when one chunk does not fit (then it walks in device memory)
  const long long CR = static_cast<long long>(C) * p.R;
  const long long chunk_bytes = 4 * (2 * (CR | 1) + (C | 1));
  const long long room = (kWalkSmem - 2LL * map_words) / chunk_bytes;
  const int per_pass = static_cast<int>(room < K ? room : K);
  const int smem = static_cast<int>(2LL * map_words + per_pass * chunk_bytes);
  const float* pe_f = static_cast<const float*>(pe);
  const int* dem_i = static_cast<const int*>(demand);
  const uint8_t* val_b = static_cast<const uint8_t*>(valid);
  const int* s0_i = static_cast<const int*>(size0);
  uint16_t* maps_h = static_cast<uint16_t*>(maps);
  int* bud = static_cast<int*>(budgets);
  int* out = static_cast<int*>(size_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.R) {
    case 1:
      return launch<1>(pe_f, dem_i, val_b, valid_stride, s0_i, B, F, C, K,
                       groups, p, map_words, maps_h, per_pass, smem, bud,
                       out, st);
    case 2:
      return launch<2>(pe_f, dem_i, val_b, valid_stride, s0_i, B, F, C, K,
                       groups, p, map_words, maps_h, per_pass, smem, bud,
                       out, st);
    case 4:
      return launch<4>(pe_f, dem_i, val_b, valid_stride, s0_i, B, F, C, K,
                       groups, p, map_words, maps_h, per_pass, smem, bud,
                       out, st);
    default:
      return launch<0>(pe_f, dem_i, val_b, valid_stride, s0_i, B, F, C, K,
                       groups, p, map_words, maps_h, per_pass, smem, bud,
                       out, st);
  }
}
