"""K1: the Huffman bit-count histogram of ``loop.count_all``.

The rate loop's bit evaluations no longer reach it on a CUDA tensor:
they run ``ops/bits_at.py``, K1 redesigned with the chain around it.

Replaces the Pallas TPU kernel ``mp3tpu/ops/pallas_bits.py:_kernel``
(called through ``pallas_bits.hist_c1``).  For a quantized granule batch
in traversal order (short granules permuted sfb -> window -> line) it
returns, as exact integers:

  bits_tab[g, r, t]  Huffman bits of region r's valid pairs under pair
                     table t, for all 32 tables (a 256-class pair
                     histogram contracted with the pair_bits LUT);
  mx[g, r]           the largest pair component in region r (>= 0);
  c1_b0raw[g]        count1-region quad bits under table A, with the
                     conformant quad index 8v+4w+2x+y;
  c1_signs[g]        count1-region sign bits.

``hist_c1`` launches the CUDA kernel (``csrc/hist_c1.cu``) for a CUDA
tensor and runs ``hist_c1_plain`` for a CPU tensor; there is no
fallback between the two.  ``hist_c1_plain`` is a direct
``scatter_add_`` histogram plus an integer-exact contraction; on the
card it is the kernel's oracle.

What bounds the kernel on an H100: a granule reads about 2.3 KB of
quantized values (576 int32) and writes 404 bytes, so a whole batch
moves a few MB and the kernel is latency- and atomic-bound, not
bandwidth-bound.  Its design: one CTA per granule and one thread per
pair, the 3x256 histogram built with shared-memory atomics, the 8 KB
LUT staged in shared memory and contracted by all 288 threads (three
partial sums per (region, table) output), and the count1 quads reduced
with warp shuffles -- no one-hot, no matrix unit, any batch size G.

The library is built from the repository's source with ``nvcc`` on
first use into ``mp3tpu_torch/build/``; importing this module needs no
toolkit.
"""
import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

from ..tables.huffman import HUFF
from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "hist_c1.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libhist_c1.so")
NVCC_FLAGS = cuda_build.NVCC_FLAGS

#: (256, 32) int8: pair_bits transposed, class-major (the kernel's LUT)
PAIR_BITS_T = np.ascontiguousarray(HUFF.pair_bits.astype(np.int8).T)
#: (16,) int32: count1 table A code lengths
C1_HLEN_A = HUFF.hlen[32, 0, :16].astype(np.int32)


def build(force=False, extra_flags=()):
    """Compile csrc/hist_c1.cu into build/libhist_c1.so (if the library
    is missing or older than the source); returns nvcc's output."""
    return cuda_build.build(SOURCE, LIBRARY, NVCC_FLAGS + list(extra_flags),
                            force)


@lru_cache(maxsize=None)
def _library():
    build()
    lib = ctypes.CDLL(LIBRARY)
    fn = lib.mp3_hist_c1
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 5)
    return lib


@lru_cache(maxsize=None)
def _device_tables(device):
    """LUT and count1 lengths resident on `device` (uploaded once)."""
    return (torch.from_numpy(PAIR_BITS_T).to(device),
            torch.from_numpy(C1_HLEN_A).to(device))


def hist_c1(ixp, a1, a2, big_values, count1, is_short, r0_pairs_short):
    """Bit-count histogram of a permuted quantized batch.

    ixp (G, 576) int32 non-negative magnitudes; a1, a2, big_values,
    count1 (G,) int32; is_short (G,) bool; r0_pairs_short: the short
    blocks' region-0 boundary in pairs.  Returns (bits_tab (G, 3, 32)
    float32, mx (G, 3) int32, c1_b0raw (G,) int32, c1_signs (G,) int32),
    the integers of ``pallas_bits.hist_c1``.

    A CPU tensor runs ``hist_c1_plain``; a CUDA tensor launches the
    kernel (and counts the launch in ``hist_c1.launches``) or raises."""
    dev = ixp.device
    if dev.type == "cpu":
        return hist_c1_plain(ixp, a1, a2, big_values, count1, is_short,
                             r0_pairs_short)
    if dev.type != "cuda":
        raise ValueError(f"hist_c1: unsupported device {dev}")
    G = ixp.shape[0]
    check = cuda_build.check
    check("hist_c1", "ixp", ixp, torch.int32, (G, 576), dev)
    for name, t in (("a1", a1), ("a2", a2), ("big_values", big_values),
                    ("count1", count1)):
        check("hist_c1", name, t, torch.int32, (G,), dev)
    check("hist_c1", "is_short", is_short, torch.bool, (G,), dev)
    pbt, c1h = _device_tables(dev)
    bits = torch.empty((G, 3, 32), dtype=torch.int32, device=dev)
    mx = torch.empty((G, 3), dtype=torch.int32, device=dev)
    b0raw = torch.empty((G,), dtype=torch.int32, device=dev)
    signs = torch.empty((G,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp3_hist_c1(
            ixp.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            big_values.data_ptr(), count1.data_ptr(), is_short.data_ptr(),
            pbt.data_ptr(), c1h.data_ptr(), G, int(r0_pairs_short),
            bits.data_ptr(), mx.data_ptr(), b0raw.data_ptr(),
            signs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist_c1: kernel launch failed, CUDA error {err}")
    hist_c1.launches += 1
    return bits.to(torch.float32), mx, b0raw, signs


hist_c1.launches = 0


def hist_c1_plain(ixp, a1, a2, big_values, count1, is_short,
                  r0_pairs_short):
    """Plain PyTorch version of ``hist_c1``: same arguments, same
    integers, on any device."""
    G = ixp.shape[0]
    dev = ixp.device
    pbt, c1h = _device_tables(dev)
    pairs = ixp.reshape(G, 288, 2).to(torch.int64)
    x, y = pairs[..., 0], pairs[..., 1]
    p = torch.arange(288, device=dev)
    pos2 = 2 * p
    a1c, a2c = a1.to(torch.int64)[:, None], a2.to(torch.int64)[:, None]
    bvr = 2 * big_values.to(torch.int64)[:, None]
    shortc = is_short[:, None]
    long_region = torch.where(pos2 < a1c, 0, torch.where(pos2 < a2c, 1, 2))
    short_region = (p >= int(r0_pairs_short)).to(torch.int64)[None, :]
    region = torch.where(shortc, short_region, long_region)
    valid = shortc | (pos2 < bvr)

    # histogram: one slot per (granule, region, class), plus a dump slot
    # for pairs outside every region (or with a negative component)
    counted = valid & (x >= 0) & (y >= 0)
    pidx = x.clamp(max=15) * 16 + y.clamp(max=15)
    dump = G * 3 * 256
    slot = torch.where(
        counted,
        (torch.arange(G, device=dev)[:, None] * 3 + region) * 256 + pidx,
        dump)
    hist = torch.zeros(dump + 1, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, slot.reshape(-1),
                      torch.ones(G * 288, dtype=torch.int64, device=dev))
    hist = hist[:dump].reshape(G, 3, 256)
    # counts <= 288 and costs <= 47: every product and sum is an integer
    # below 2^24, exact in float32 (TF32 is off package-wide)
    bits_tab = (hist.to(torch.float32).reshape(G * 3, 256)
                @ pbt.to(torch.float32)).reshape(G, 3, 32)

    pmax = torch.maximum(x, y)
    mx = torch.stack(
        [torch.where(valid & (region == r), pmax, 0).amax(dim=1)
         for r in range(3)], dim=1)

    # count1: realign misaligned granules by rolling two lines left
    start = 2 * big_values.to(torch.int64)
    mis = (start % 4) != 0
    ixs = torch.where(mis[:, None], torch.roll(ixp, -2, dims=1), ixp)
    start_al = torch.where(mis, start - 2, start)
    quads = ixs.to(torch.int64).clamp(max=1).reshape(G, 144, 4)
    p16 = (8 * quads[..., 0] + 4 * quads[..., 1] + 2 * quads[..., 2]
           + quads[..., 3])
    q4 = 4 * torch.arange(144, device=dev)[None, :]
    inr = ((q4 >= start_al[:, None])
           & (q4 < (start_al + 4 * count1.to(torch.int64))[:, None]))
    has_class = inr & (p16 >= 0) & (p16 < 16)
    b0raw = torch.where(has_class, c1h.to(torch.int64)[p16.clamp(0, 15)],
                        0).sum(dim=1)
    signs = torch.where(inr, quads.sum(dim=2), 0).sum(dim=1)
    return (bits_tab, mx.to(torch.int32), b0raw.to(torch.int32),
            signs.to(torch.int32))
