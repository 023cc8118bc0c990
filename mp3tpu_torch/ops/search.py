"""K3: the rate loop's stepsize searches, one launch per search.

The JAX package runs ``search_stepsize`` (an 8-step bisection, a walk up
while over budget, 3 downward steps) and ``search_walk`` (the walk up
from a warm start) as device loops inside its compiled segment program
(``mp3tpu/ops/jaxloop.py:528-613``).  Here each search is one launch of
``search_kernel`` (``csrc/bits_at.cu``, in the library it shares with
``bits_at``): one warp runs one granule's whole search, evaluating the
bits with ``bits_at``'s code, and no step returns to the host.  A CPU
tensor runs the lockstep plain versions ``loop.search_stepsize_plain``
and ``loop.search_walk_plain`` instead; there is no fallback between
the two.

Both forms return (qss, bits, counts): qss and bits (G,) float32 (bits
1e9 past IXMAX), and the counts dict of ``bits_at`` at qss with
``evals`` (G,) int32, each granule's bit evaluations.  The kernel's
counts also hold ``status`` (G,) int32: 1 where a stepsize of the search
was not an integer in [-512, 511] and its factor came from ``exp2f``
instead of torch's table (never, for stepsizes the searches make; the
wrapper does not read it, so nothing waits on the card).  The kernel's
rows are views of one (15, G) buffer.

What bounds the kernel on an H100, and its design: see the note at the
top of ``csrc/bits_at.cu``.
"""
import ctypes
from functools import lru_cache

import torch

from . import bits_at, cuda_build, loop

#: the kernel's rows after bits_at's ROWS
EXTRA_ROWS = ("qss", "evals", "status")
#: the stepsizes whose factor 2^(-0.1875 q) the kernel reads from a table
STEP_LO, STEP_HI = -512, 511
#: K3's launches (``search_stepsize`` and ``search_walk`` together)
launches = 0


def build(force=False, extra_flags=()):
    """Compile csrc/bits_at.cu (both kernels) into build/libbits_at.so."""
    return bits_at.build(force, extra_flags)


@lru_cache(maxsize=None)
def _library():
    lib = bits_at._library()
    fn = lib.mp3_search
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    return lib


@lru_cache(maxsize=None)
def _istep_table(device):
    """2^(-0.1875 q) for q = STEP_LO..STEP_HI, computed on `device` by
    torch's exp2 as ``loop.quantize_pow75`` computes it."""
    q = torch.arange(STEP_LO, STEP_HI + 1, dtype=torch.float32,
                     device=device)
    return torch.exp2(-0.1875 * q)


def _check_inputs(xr75p, budget, start, qss_lo, is_short, is_short_block):
    dev = xr75p.device
    G = xr75p.shape[0] if xr75p.dim() else 0
    args = [("xr75p", xr75p, torch.float32, (G, 576)),
            ("budget", budget, torch.float32, (G,)),
            ("start", start, torch.float32, (G,)),
            ("is_short", is_short, torch.bool, (G,)),
            ("is_short_block", is_short_block, torch.bool, (G,))]
    if qss_lo is not None:
        args.append(("qss_lo", qss_lo, torch.float32, (G,)))
    for name, t, dtype, shape in args:
        cuda_build.check("search", name, t, dtype, shape, dev)
    return dev


def _launch(walk, xr75p, budget, start, qss_lo, is_short, is_short_block,
            ST, n_bisect, max_steps):
    global launches
    dev, G = xr75p.device, xr75p.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"search: unsupported device {dev}")
    tab = ST["bits_at_tab"]
    cuda_build.check("search", "ST['bits_at_tab']", tab, torch.int32,
                     (bits_at.RATE_INTS,), dev)
    if xr75p.data_ptr() % 16:
        raise ValueError("search: xr75p must be 16-byte aligned")
    rows = bits_at.ROWS + EXTRA_ROWS
    out = torch.empty((len(rows), G), dtype=torch.int32, device=dev)
    if G:
        lut, hlen = bits_at._device_tables(dev)
        istep = _istep_table(dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp3_search(
                xr75p.data_ptr(), budget.data_ptr(), start.data_ptr(),
                None if qss_lo is None else qss_lo.data_ptr(),
                is_short.data_ptr(), is_short_block.data_ptr(),
                tab.data_ptr(), lut.data_ptr(), hlen.data_ptr(),
                istep.data_ptr(), int(ST["r0_pairs_short"]), int(walk),
                int(n_bisect), int(max_steps), G, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"search: kernel launch failed, CUDA error "
                               f"{err}")
        launches += 1
    c = {k: out[i] for i, k in enumerate(rows) if k != "table_select"}
    c["bits"] = out[0].view(torch.float32)
    c["table_select"] = out[7:10].t()
    qss = c.pop("qss").view(torch.float32)
    return qss, c["bits"], c


def search_stepsize(xr75p, budget, qanf, is_short, is_short_block, ST,
                    n_bisect=8, qss_lo=None):
    """``loop.search_stepsize_plain`` in one launch per batch.

    xr75p (G, 576) float32 permuted |xr|^0.75; budget, qanf and qss_lo
    (optional) (G,) float32; is_short, is_short_block (G,) bool; ST the
    rate's ``device_tables``.  Inputs are checked first on every device.
    A CPU tensor then runs the plain version; a CUDA tensor launches K3
    (and counts it in ``search.launches``) or raises."""
    dev = _check_inputs(xr75p, budget, qanf, qss_lo, is_short,
                        is_short_block)
    if dev.type == "cpu":
        return loop.search_stepsize_plain(xr75p, budget, qanf, is_short,
                                          is_short_block, ST,
                                          n_bisect=n_bisect, qss_lo=qss_lo)
    return _launch(False, xr75p, budget, qanf, qss_lo, is_short,
                   is_short_block, ST, n_bisect, 40)


def search_walk(xr75p, budget, start_qss, is_short, is_short_block, ST,
                max_steps=40):
    """``loop.search_walk_plain`` in one launch per batch; arguments and
    dispatch as ``search_stepsize``."""
    dev = _check_inputs(xr75p, budget, start_qss, None, is_short,
                        is_short_block)
    if dev.type == "cpu":
        return loop.search_walk_plain(xr75p, budget, start_qss, is_short,
                                      is_short_block, ST,
                                      max_steps=max_steps)
    return _launch(True, xr75p, budget, start_qss, None, is_short,
                   is_short_block, ST, 0, max_steps)
