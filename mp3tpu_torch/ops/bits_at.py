"""One bit evaluation of the rate loop in one launch: ``bits_at``.

Each bit evaluation of the rate loop's stepsize searches is
``jaxloop._bits_at``: quantize the permuted |xr|^0.75 at the stepsize,
find the run lengths, subdivide the big_values region, count the Huffman
bits of every table candidate (K1's histogram,
``mp3tpu/ops/pallas_bits.py:_kernel``) and pick the tables and the
count1 table.  ``bits_at`` does all of it in one CUDA kernel
(``csrc/bits_at.cu``) for a CUDA tensor and runs ``bits_at_plain``, the
same chain in plain PyTorch, for a CPU tensor; there is no fallback
between the two.

Its evaluation is K3's building block: ``search_kernel`` in the same
source runs the searches on the card and calls the same ``__device__``
evaluation at every step (``ops/search.py``).  So on the card the rate
loop launches ``bits_at`` no time; it is the plain searches' evaluation
(``loop.search_stepsize_plain``, ``search_walk_plain``) and the baseline
that ``chip_smoke.py`` phase 3b holds against ``bits_at_plain``.

Both return one dict of per-granule rows: ``bits`` (G,) float32 (1e9
where ix_max > IXMAX), ``count1``, ``big_values``, ``r0``, ``r1``,
``a1``, ``a2``, ``table_select`` (G, 3), ``count1table_select`` and
``ix_max``, all int32.  The kernel's rows are views of one (12, G)
buffer.

What bounds the kernel on an H100, and its design: see the note at the
top of ``csrc/bits_at.cu``.  The library is built from the repository's
source with ``nvcc`` on first use into ``mp3tpu_torch/build/``.
"""
import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

from ..tables import mpeg
from ..tables.huffman import (ESC_TABLE_A, ESC_TABLE_B, FIRST_TABLE_FOR_MAX,
                              HUFF)
from . import cuda_build, loop
from .hist_c1 import hist_c1_plain

SOURCE = os.path.join(cuda_build.CSRC, "bits_at.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libbits_at.so")
#: no FMA contraction: the quantizer rounds every operation as torch does
NVCC_FLAGS = cuda_build.NVCC_FLAGS + ["-fmad=false"]

#: the kernel's output rows, in order (table_select takes three)
ROWS = ("bits", "count1", "big_values", "r0", "r1", "a1", "a2",
        "table_select", "table_select", "table_select",
        "count1table_select", "ix_max")

#: (32, 256) int8: pair_bits, table-major (the kernel's LUT rows)
PAIR_BITS = np.ascontiguousarray(HUFF.pair_bits.astype(np.int8))
#: (16,) int32: count1 table A code lengths
C1_HLEN_A = HUFF.hlen[32, 0, :16].astype(np.int32)


def rate_tables(sfb_l):
    """The kernel's per-rate int32 table pack (csrc/bits_at.cu kSfbL..):
    the 23 long sfb boundaries, SUBDV_TABLE (23 x 2), the first table by
    max (15), and the ESC tables A and B by max - 15 (8193 each)."""
    parts = (np.asarray(sfb_l)[:23], mpeg.SUBDV_TABLE, FIRST_TABLE_FOR_MAX,
             ESC_TABLE_A, ESC_TABLE_B)
    return np.concatenate([np.asarray(p, np.int64).reshape(-1)
                           for p in parts]).astype(np.int32)


RATE_INTS = rate_tables(np.zeros(23)).shape[0]


def build(force=False, extra_flags=()):
    """Compile csrc/bits_at.cu into build/libbits_at.so (if the library
    is missing or older than the source); returns nvcc's output."""
    return cuda_build.build(SOURCE, LIBRARY, NVCC_FLAGS + list(extra_flags),
                            force)


@lru_cache(maxsize=None)
def _library():
    build()
    lib = ctypes.CDLL(LIBRARY)
    fn = lib.mp3_bits_at
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    return lib


@lru_cache(maxsize=None)
def _device_tables(device):
    """LUT and count1 lengths resident on `device` (uploaded once)."""
    return (torch.from_numpy(PAIR_BITS).to(device),
            torch.from_numpy(C1_HLEN_A).to(device))


def _check_inputs(xr75p, qss, is_short, is_short_block):
    dev = xr75p.device
    G = xr75p.shape[0] if xr75p.dim() else 0
    for name, t, dtype, shape in (
            ("xr75p", xr75p, torch.float32, (G, 576)),
            ("qss", qss, torch.float32, (G,)),
            ("is_short", is_short, torch.bool, (G,)),
            ("is_short_block", is_short_block, torch.bool, (G,))):
        cuda_build.check("bits_at", name, t, dtype, shape, dev)
    return dev, G


def bits_at(xr75p, qss, is_short, is_short_block, ST):
    """Bits and full counts of a permuted |xr|^0.75 batch at stepsizes qss.

    xr75p (G, 576) float32 in traversal order; qss (G,) float32;
    is_short, is_short_block (G,) bool; ST the rate's ``device_tables``.
    Returns the dict of the module docstring.

    Inputs are checked first on every device.  A CPU tensor then runs
    ``bits_at_plain``; a CUDA tensor launches the kernel (and counts the
    launch in ``bits_at.launches``; a launch made into a CUDA graph of
    ``loop.outer_loop`` counts at each replay instead) or raises."""
    dev, G = _check_inputs(xr75p, qss, is_short, is_short_block)
    if dev.type == "cpu":
        return bits_at_plain(xr75p, qss, is_short, is_short_block, ST)
    if dev.type != "cuda":
        raise ValueError(f"bits_at: unsupported device {dev}")
    tab = ST["bits_at_tab"]
    cuda_build.check("bits_at", "ST['bits_at_tab']", tab, torch.int32,
                     (RATE_INTS,), dev)
    if xr75p.data_ptr() % 16:
        raise ValueError("bits_at: xr75p must be 16-byte aligned")
    lut, hlen = _device_tables(dev)
    # the wrapper takes torch's exp2, so the factor is the plain chain's
    istep75 = torch.exp2(-0.1875 * qss)
    out = torch.empty((len(ROWS), G), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp3_bits_at(
            xr75p.data_ptr(), istep75.data_ptr(), is_short.data_ptr(),
            is_short_block.data_ptr(), tab.data_ptr(), lut.data_ptr(),
            hlen.data_ptr(), int(ST["r0_pairs_short"]), G, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"bits_at: kernel launch failed, CUDA error {err}")
    bits_at.launches += 1
    c = {k: out[i] for i, k in enumerate(ROWS) if k != "table_select"}
    c["bits"] = out[0].view(torch.float32)
    c["table_select"] = out[7:10].t()
    return c


bits_at.launches = 0


def bits_at_plain(xr75p, qss, is_short, is_short_block, ST):
    """Plain PyTorch version of ``bits_at``: the eager chain quantize ->
    run lengths -> subdivide -> histogram (``hist_c1_plain``) -> table
    choice, on any device; same arguments, same values."""
    ixp = loop.quantize_pow75(xr75p, qss)
    c = loop.count_all(ixp, is_short, is_short_block, ST, pre_permuted=True,
                       hist=hist_c1_plain)
    c["bits"] = torch.where(c["ix_max"] <= loop.IXMAX, c["bits"], 1e9)
    return c
