// Layer I/II frame packing with its CRC (K6) for Hopper: one block a frame.
//
// Replaces the host end of the JAX package's Layer I/II path,
// mp3tpu/encoder.py:837-840: the flat (value, length) element stream of
// its marshalling (mp3tpu/encoder.py:904) packed MSB-first by
// native/mp3bits.cpp mp3bits_pack
// (runtime/bitstream.py pack_elements), with each frame's CRC-16 computed
// beforehand in a Python loop over frames by numpy_ref/layer12.py _crc_calc
// (common.c:1251-1308).  Its plain version is pack_frames_plain in
// ops/pack12.py, a bit array built with torch ops.
//
// A frame on the CBR grid has a fixed size (the padding bit never fires),
// so frame f owns the bytes [f * frame_bytes, (f + 1) * frame_bytes) and
// the frames pack independently.  Block f:
//   1. each thread sums the lengths of its run of the frame's E elements,
//      and a block-wide exclusive scan (warp shuffles, then the warps'
//      sums) gives each run's bit offset;
//   2. each thread ORs its elements' bits -- at most 32, masked to the
//      element's length, so an element spans at most two 32-bit words --
//      into a shared-memory copy of the frame (atomicOr: neighbouring
//      elements share words);
//   3. with the CRC on, one thread runs CRC-16 (polynomial 0x8005, start
//      0xffff, bit by bit as _update_crc) over header bits 16-31 and then
//      the bits of the elements [crc_first, crc_end) -- the bit allocation
//      and the scfsi, contiguous after the 16-bit CRC field -- and writes
//      it into bits 32-47, which the CRC element left zero;
//   4. the block writes the frame's bytes out.
// A frame whose lengths do not sum to 8 * frame_bytes, or an element
// length outside [0, 32], counts into the status words; bits past the
// frame's end are dropped, so no frame writes outside its range.
//
// What bounds it: the bytes, the (F, E) int32 values and lengths read once
// and the frames written once (chip_smoke.py k6_bound); the scan and the
// shared-memory ORs are a few operations an element, and the CRC's serial
// walk is at most ~400 bits a frame.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpack12.so pack12.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bit_at(const uint32_t* words, int b) {
  return (words[b >> 5] >> (31 - (b & 31))) & 1;
}

__global__ void __launch_bounds__(kThreads)
pack12_kernel(const int32_t* __restrict__ values,
              const int32_t* __restrict__ lengths, int E, int frame_bytes,
              int crc_first, int crc_end, uint8_t* __restrict__ out,
              int32_t* __restrict__ status) {
  extern __shared__ uint32_t words[];       // the frame's words, and one
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int crc_bits[2];
  __shared__ int bad_lengths;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long f = blockIdx.x;
  const int32_t* v = values + f * E;
  const int32_t* l = lengths + f * E;
  const int frame_bits = 8 * frame_bytes;
  const int nwords = (frame_bytes + 3) / 4;
  for (int i = tid; i <= nwords; i += kThreads) words[i] = 0;
  if (tid == 0) crc_bits[0] = crc_bits[1] = bad_lengths = 0;

  // this thread's run of elements and its bits
  const int per = (E + kThreads - 1) / kThreads;
  const int lo = tid * per < E ? tid * per : E;
  const int hi = lo + per < E ? lo + per : E;
  int mine = 0, bad = 0;
  for (int e = lo; e < hi; ++e) {
    const int n = l[e];
    if (n < 0 || n > 32) ++bad;
    else mine += n;
  }
  // block-wide exclusive scan of the runs' bits
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    total += warp_sums[w];
  }
  int off = before + incl - mine;
  if (bad) atomicAdd(&bad_lengths, bad);

  for (int e = lo; e < hi; ++e) {
    int n = l[e];
    if (n < 0 || n > 32) n = 0;
    if (e == crc_first) crc_bits[0] = off;
    if (e == crc_end) crc_bits[1] = off;
    if (n > 0 && off < frame_bits) {
      uint32_t u = static_cast<uint32_t>(v[e]);
      if (n < 32) u &= (1u << n) - 1u;
      const int w = off >> 5, s = off & 31;
      if (s + n <= 32) {
        atomicOr(&words[w], u << (32 - s - n));
      } else {
        atomicOr(&words[w], u >> (s + n - 32));
        atomicOr(&words[w + 1], u << (64 - s - n));
      }
    }
    off += n;
  }
  if (tid == kThreads - 1) {
    if (crc_first == E) crc_bits[0] = total;
    if (crc_end == E) crc_bits[1] = total;
  }
  __syncthreads();
  if (tid == 0 && (total != frame_bits || bad_lengths)) {
    atomicAdd(&status[0], 1);
    atomicAdd(&status[1], bad_lengths);
  }

  if (crc_first >= 0 && tid == 0) {
    unsigned crc = 0xffffu;
    const int end = crc_bits[1] < frame_bits ? crc_bits[1] : frame_bits;
    for (int pass = 0; pass < 2; ++pass) {
      const int b0 = pass ? crc_bits[0] : 16;
      const int b1 = pass ? end : 32;
      for (int b = b0; b < b1; ++b) {
        const unsigned carry = (crc >> 15) & 1u;
        crc = (crc << 1) & 0xffffu;
        if (carry ^ static_cast<unsigned>(bit_at(words, b))) crc ^= 0x8005u;
      }
    }
    words[1] |= crc << 16;                // bits 32-47
  }
  __syncthreads();

  uint8_t* dst = out + f * frame_bytes;
  for (int b = tid; b < frame_bytes; b += kThreads)
    dst[b] = static_cast<uint8_t>(words[b >> 2] >> (24 - 8 * (b & 3)));
}

}  // namespace

// K6 over F frames of E elements on `stream`: values and lengths (F, E)
// int32 (a value's low `length` bits are sent), frame_bytes bytes a frame
// into out (F * frame_bytes uint8); with crc_first >= 0 the CRC covers
// header bits 16-31 and the elements [crc_first, crc_end) and goes into
// bits 32-47.  status (2,) int32, zeroed by the caller, counts the frames
// whose lengths do not sum to the frame's bits and the element lengths
// outside [0, 32].  Returns the launch's CUDA error (0 on success).
extern "C" int mp3_pack12(const void* values, const void* lengths, int F,
                          int E, int frame_bytes, int crc_first, int crc_end,
                          void* out, void* status, void* stream) {
  if (F <= 0) return 0;
  if (E < 1 || frame_bytes < 6 || frame_bytes > 8192 ||
      (crc_first >= 0 && (crc_first > crc_end || crc_end > E)))
    return cudaErrorInvalidValue;
  const int smem = 4 * ((frame_bytes + 3) / 4 + 1);
  pack12_kernel<<<F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values),
      static_cast<const int32_t*>(lengths), E, frame_bytes, crc_first,
      crc_end, static_cast<uint8_t*>(out), static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
