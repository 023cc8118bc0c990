// Bit-reservoir budget scan (K4) for Hopper, one block per clip.
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
// What bounds it: the carry.  Every granule's budget depends on the
// level that the granule before it left, through some 12 dependent
// integer operations, so one block walks one clip's F*R granules in
// order.  The bytes (16 a granule) and the operations are a few
// microseconds' worth on an H100; the chain's latency is the floor of
// this design.  The block's threads first stage a tile of granules in
// shared memory in parallel -- more_bits (the only double arithmetic,
// independent of the carry), the demand and the frames' valid flags --
// then one thread walks the carry through the tile reading shared
// memory only, and all threads write the tile's budgets out.  A corpus
// group runs its clips as parallel blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -o libresv_scan.so
//        resv_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// granules a block stages per pass: 3 int arrays + the frames' flags,
// 26 KB of static shared memory
constexpr int kTile = 2048;

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

__global__ void __launch_bounds__(kThreads)
resv_scan_kernel(const float* __restrict__ pe,
                 const int* __restrict__ demand,
                 const uint8_t* __restrict__ valid, int valid_stride,
                 const int* __restrict__ size0, int F, int nch, int mode_gr,
                 int mean_bits, int resv_max, int delta,
                 int* __restrict__ budgets, int* __restrict__ size_out) {
  __shared__ int s_more[kTile];
  __shared__ int s_dem[kTile];
  __shared__ int s_bud[kTile];
  __shared__ uint8_t s_val[kTile];
  __shared__ int s_size;

  const int R = mode_gr * nch;
  const long long n = static_cast<long long>(F) * R;
  const int clip = blockIdx.x;
  const float* pe_c = pe + clip * n;
  const int* dem_c = demand + clip * n;
  int* bud_c = budgets + clip * n;
  const uint8_t* val_c =
      valid ? valid + static_cast<long long>(clip) * valid_stride : nullptr;
  const int mean = mean_bits / nch;
  const int max_bits = mean < 4095 ? mean : 4095;
  const int frames_per_tile = kTile / R;

  if (threadIdx.x == 0) s_size = size0[clip];
  for (int f0 = 0; f0 < F; f0 += frames_per_tile) {
    const int nf = min(frames_per_tile, F - f0);
    const int ng = nf * R;
    const long long g0 = static_cast<long long>(f0) * R;
    // stage the tile: everything that does not depend on the carry
    for (int i = threadIdx.x; i < ng; i += kThreads) {
      s_more[i] = more_bits_of(pe_c[g0 + i], mean);
      s_dem[i] = dem_c[g0 + i];
    }
    for (int i = threadIdx.x; i < nf; i += kThreads)
      s_val[i] = val_c ? val_c[f0 + i] : 1;
    __syncthreads();
    if (threadIdx.x == 0) {
      // the carry, in order (mp3bits.cpp mp3resv_scan, mode 0)
      int size = s_size;
      for (int f = 0; f < nf; ++f) {
        const int size_in = size;
        for (int r = 0; r < R; ++r) {
          const int i = f * R + r;
          int b;
          if (resv_max == 0) {
            b = max_bits;
          } else {
            const int more = s_more[i];
            int add = 0;
            if (more > 100) {
              const int frac = (size * 6) / 10;
              add = frac < more ? frac : more;
            }
            const int over = size - (resv_max * 8) / 10 - add;
            if (over > 0) add += over;
            b = max_bits + add;
            if (b > 4095) b = 4095;
          }
          s_bud[i] = b;
          const int dem = s_dem[i];
          int used = dem < b ? dem : b - delta;
          if (used < 0) used = 0;
          size += mean - used;
        }
        if (nch == 2 && (mean_bits & 1)) size += 1;
        if (size > resv_max) size = resv_max;
        size -= size % 8;
        // a padded frame leaves the level as it found it
        if (!s_val[f]) size = size_in;
      }
      s_size = size;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += kThreads) bud_c[g0 + i] = s_bud[i];
    __syncthreads();          // the tile's shared arrays are free again
  }
  if (threadIdx.x == 0) size_out[clip] = s_size;
}

}  // namespace

// B clips of F frames: pe (B, F, R) float32, demand (B, F, R) int32,
// valid NULL (every frame real) or uint8 flags with `valid_stride` bytes
// from one clip's to the next (0: one (F,) row for every clip), size0
// (B,) int32; budgets (B, F, R) int32 and size_out (B,) int32 out, with
// R = mode_gr * nch <= kTile.  Launches on `stream` and returns
// cudaGetLastError(): a refused launch never runs.
extern "C" int mp3_resv_scan(const void* pe, const void* demand,
                             const void* valid, int valid_stride,
                             const void* size0, int B, int F, int nch,
                             int mode_gr, int mean_bits, int resv_max,
                             int delta, void* budgets, void* size_out,
                             void* stream) {
  if (B <= 0) return 0;
  resv_scan_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pe), static_cast<const int*>(demand),
      static_cast<const uint8_t*>(valid), valid_stride,
      static_cast<const int*>(size0), F, nch, mode_gr, mean_bits, resv_max,
      delta, static_cast<int*>(budgets), static_cast<int*>(size_out));
  return static_cast<int>(cudaGetLastError());
}
