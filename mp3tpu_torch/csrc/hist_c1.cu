// Rate-loop bit-count histogram (K1) for Hopper, one CTA per granule.
//
// Replaces the Pallas TPU kernel mp3tpu/ops/pallas_bits.py:_kernel.  For
// a quantized granule batch in traversal order it computes, as exact
// integers:
//   bits[g, r, t] = sum over valid pairs p in region r of pair_bits[t, pidx(p)]
//   mx[g, r]      = max pair component over region r's valid pairs (>= 0)
//   b0raw[g]      = count1-region quad bits under table A (index 8v+4w+2x+y)
//   signs[g]      = count1-region sign bits
// The plain PyTorch version, mp3tpu_torch/ops/hist_c1.py:hist_c1_plain,
// computes the same integers and is the oracle for this kernel.
//
// The TPU kernel fed its matrix unit with a selector/one-hot product.  A
// CTA here builds the 3x256 pair histogram directly with shared-memory
// atomics (one thread per pair), contracts it against the 256x32 LUT
// staged in shared memory (3 threads per (region, table) output, each
// over a third of the classes), and reduces the 144 count1 quads with
// warp shuffles.  A granule reads 2304 bytes of ix; the kernel is
// latency- and atomic-bound, not bandwidth-bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libhist_c1.so hist_c1.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLines = 576;
constexpr int kPairs = 288;
constexpr int kQuads = 144;
constexpr int kClasses = 256;
constexpr int kTables = 32;
constexpr int kRegions = 3;
constexpr int kThreads = kPairs;              // one thread per pair
constexpr int kOut = kRegions * kTables;      // 96 (region, table) sums
constexpr int kSplit = kThreads / kOut;       // 3 partial sums per output
constexpr int kSlice = (kClasses + kSplit - 1) / kSplit;

static_assert(kThreads % 32 == 0, "whole warps");
static_assert(kThreads == kSplit * kOut, "every thread takes one partial");

__global__ void __launch_bounds__(kThreads)
hist_c1_kernel(const int* __restrict__ ixp, const int* __restrict__ a1,
               const int* __restrict__ a2, const int* __restrict__ big_values,
               const int* __restrict__ count1,
               const uint8_t* __restrict__ is_short,
               const int8_t* __restrict__ pbt, const int* __restrict__ c1_hlen,
               int r0_pairs_short, int* __restrict__ bits,
               int* __restrict__ mx, int* __restrict__ b0raw,
               int* __restrict__ signs) {
  __shared__ int hist[kRegions * kClasses];
  __shared__ __align__(16) int8_t lut[kClasses * kTables];  // lut[c * 32 + t]
  __shared__ int part[kSplit * kOut];
  __shared__ int smx[kRegions];
  __shared__ int hl[16];
  __shared__ int c1acc[2];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int* row = ixp + static_cast<size_t>(g) * kLines;

  for (int i = tid; i < kRegions * kClasses; i += kThreads) hist[i] = 0;
  const int* pbt4 = reinterpret_cast<const int*>(pbt);
  int* lut4 = reinterpret_cast<int*>(lut);
  for (int i = tid; i < kClasses * kTables / 4; i += kThreads) lut4[i] = pbt4[i];
  if (tid < kRegions) smx[tid] = 0;
  if (tid < 16) hl[tid] = c1_hlen[tid];
  if (tid < 2) c1acc[tid] = 0;
  __syncthreads();

  const bool shrt = is_short[g] != 0;
  const int addr1 = a1[g];
  const int addr2 = a2[g];
  const int bv = big_values[g];
  const int nquad = count1[g];

  // ---- pair pass: region, validity, histogram class and region max
  {
    const int p = tid;
    const int x = row[2 * p];
    const int y = row[2 * p + 1];
    const int pos2 = 2 * p;
    int r;
    bool valid;
    if (shrt) {
      r = p < r0_pairs_short ? 0 : 1;
      valid = true;
    } else {
      r = pos2 < addr1 ? 0 : (pos2 < addr2 ? 1 : 2);
      valid = pos2 < 2 * bv;
    }
    if (valid) {
      // a negative component has no class (the one-hot of the
      // reference formulation is all zero there)
      if (x >= 0 && y >= 0)
        atomicAdd(&hist[r * kClasses + min(x, 15) * 16 + min(y, 15)], 1);
      atomicMax(&smx[r], max(x, y));
    }
  }

  // ---- count1 pass: quad j of the realigned spectrum.  The region
  // starts at 2 * big_values, which is only 2-aligned; a misaligned
  // granule reads lines 4j+2 .. 4j+5 (mod 576), exactly the roll by -2
  // of the reference formulation.
  {
    int b = 0;
    int sg = 0;
    if (tid < kQuads) {
      const int start = 2 * bv;
      const bool mis = (start % 4) != 0;
      const int start_al = mis ? start - 2 : start;
      const int q4 = 4 * tid;
      if (q4 >= start_al && q4 < start_al + 4 * nquad) {
        int v[4];
        for (int k = 0; k < 4; ++k) {
          int line = q4 + (mis ? 2 : 0) + k;
          if (line >= kLines) line -= kLines;
          v[k] = min(row[line], 1);
        }
        const int p16 = 8 * v[0] + 4 * v[1] + 2 * v[2] + v[3];
        b = (static_cast<unsigned>(p16) < 16u) ? hl[p16] : 0;
        sg = v[0] + v[1] + v[2] + v[3];
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      b += __shfl_down_sync(0xffffffffu, b, o);
      sg += __shfl_down_sync(0xffffffffu, sg, o);
    }
    if ((tid & 31) == 0 && (b != 0 || sg != 0)) {
      atomicAdd(&c1acc[0], b);
      atomicAdd(&c1acc[1], sg);
    }
  }
  __syncthreads();

  // ---- contraction: 96 (region, table) sums over 256 classes, split
  // three ways so every thread takes one partial
  {
    const int o = tid % kOut;
    const int s = tid / kOut;
    const int r = o / kTables;
    const int t = o % kTables;
    const int c0 = s * kSlice;
    const int c1 = min(c0 + kSlice, kClasses);
    int acc = 0;
    for (int c = c0; c < c1; ++c)
      acc += hist[r * kClasses + c] * static_cast<int>(lut[c * kTables + t]);
    part[s * kOut + o] = acc;
  }
  __syncthreads();

  if (tid < kOut) {
    int acc = 0;
    for (int s = 0; s < kSplit; ++s) acc += part[s * kOut + tid];
    bits[static_cast<size_t>(g) * kOut + tid] = acc;
  }
  if (tid < kRegions) mx[static_cast<size_t>(g) * kRegions + tid] = smx[tid];
  if (tid == 0) {
    b0raw[g] = c1acc[0];
    signs[g] = c1acc[1];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, and only this return value reports it.
extern "C" int mp3_hist_c1(const void* ixp, const void* a1, const void* a2,
                           const void* big_values, const void* count1,
                           const void* is_short, const void* pbt,
                           const void* c1_hlen, int n_granules,
                           int r0_pairs_short, void* bits, void* mx,
                           void* b0raw, void* signs, void* stream) {
  if (n_granules > 0) {
    hist_c1_kernel<<<n_granules, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ixp), static_cast<const int*>(a1),
        static_cast<const int*>(a2), static_cast<const int*>(big_values),
        static_cast<const int*>(count1),
        static_cast<const uint8_t*>(is_short),
        static_cast<const int8_t*>(pbt), static_cast<const int*>(c1_hlen),
        r0_pairs_short, static_cast<int*>(bits), static_cast<int*>(mx),
        static_cast<int*>(b0raw), static_cast<int*>(signs));
  }
  return static_cast<int>(cudaGetLastError());
}
