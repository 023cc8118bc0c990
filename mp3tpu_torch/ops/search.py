"""K3: the rate loop's stepsize searches, one launch per search.

The JAX package runs ``search_stepsize`` (an 8-step bisection, a walk up
while over budget, 3 downward steps) and ``search_walk`` (the walk up
from a warm start) as device loops inside its compiled segment program
(``mp3tpu/ops/jaxloop.py:528-613``).  Here each search is one launch of
``search_kernel`` (``csrc/bits_at.cu``, in the library it shares with
``bits_at``), and no step returns to the host.  A granule gets `width`
warps: one where the batch fills the card, else 3, which evaluate the
stepsizes the next rounds of the serial search may need at once (a
bisection tree, a ladder of walk rungs, the down rungs); where the
batch outgrows the grid, a granule group that finishes takes the next
granule from a counter that the kernel sets back to zero.  An evaluation
is a pure function of (granule, stepsize), so the kernel never evaluates
a stepsize whose outcome it already knows: the accepted stepsize's rows are kept, not
evaluated again; the walk starts from the bisection's evaluated hi; the
down steps end at their first miss, and at a stepsize the bisection or
the walk found over budget.  A CPU tensor runs the lockstep plain
versions ``loop.search_stepsize_plain`` and ``loop.search_walk_plain``
instead; there is no fallback between the two.

Both forms return (qss, bits, counts): qss and bits (G,) float32 (bits
1e9 past IXMAX), and the counts dict of ``bits_at`` at qss with
``evals`` (G,) int32, each granule's bit evaluations as the plain search
counts them.  The kernel's counts also hold ``status`` (G,) int32: 1
where a stepsize of the search was not an integer in [-512, 511] and its
factor came from ``exp2f`` instead of torch's table (never, for
stepsizes the searches make; the wrapper does not read it, so nothing
waits on the card); and ``runs`` (G,) int32, the evaluations the kernel
ran for the granule, speculative ones included.  The kernel's rows are
views of one (16, G) buffer.

``launches`` counts K3's launches as they run: a launch made into a CUDA
graph (``loop.outer_loop``, the segment program's graph) is counted at
each replay of the graph, not at its capture.

What bounds the kernel on an H100, and its design: see the note at the
top of ``csrc/bits_at.cu``.
"""
import ctypes
from functools import lru_cache

import torch

from . import bits_at, cuda_build, loop

#: the kernel's rows after bits_at's ROWS
EXTRA_ROWS = ("qss", "evals", "status", "runs")
#: the stepsizes whose factor 2^(-0.1875 q) the kernel reads from a table
STEP_LO, STEP_HI = -512, 511
#: the warps a granule can take (csrc/bits_at.cu kMaxWidth)
MAX_WIDTH = 7
#: K3's launches (``search_stepsize`` and ``search_walk`` together)
launches = 0


def build(force=False, extra_flags=()):
    """Compile csrc/bits_at.cu (its kernels) into build/libbits_at.so."""
    return bits_at.build(force, extra_flags)


@lru_cache(maxsize=None)
def _library():
    lib = bits_at._library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp3_search.restype = i32
    lib.mp3_search.argtypes = [ptr] * 10 + [i32] * 6 + [ptr] * 3
    lib.mp3_search_plan.restype = i32
    lib.mp3_search_plan.argtypes = [i32, i32, ptr]
    return lib


def plan(G, width=None, device=None):
    """K3's launch for G granules on the current CUDA device (or
    `device`): dict(width, groups, threads, blocks, smem), as
    ``mp3_search`` makes it; `width` forces the warps a granule."""
    arr = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _library().mp3_search_plan(int(G), int(width or 0), arr)
    if err != 0:
        raise RuntimeError(f"search: launch plan failed, CUDA error {err}")
    return dict(zip(("width", "groups", "threads", "blocks", "smem"), arr))


@lru_cache(maxsize=None)
def _counter(device):
    """K3's granule counter on `device`: one int32, zero between launches
    (the kernel sets it back), allocated once.  One a device is enough
    while no two K3 launches run at once: the launches of one process go
    to one stream at a time (the caller's, or the rate loop's graph
    stream, which waits for the caller's and is waited for)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


@lru_cache(maxsize=None)
def _istep_table(device):
    """2^(-0.1875 q) for q = STEP_LO..STEP_HI, computed on `device` by
    torch's exp2 as ``loop.quantize_pow75`` computes it."""
    q = torch.arange(STEP_LO, STEP_HI + 1, dtype=torch.float32,
                     device=device)
    return torch.exp2(-0.1875 * q)


def device_buffers(device):
    """Every buffer a K3 launch on `device` reads besides its arguments:
    ``bits_at``'s LUT and count1 lengths, the stepsize table and the
    counter, made now if they are not yet.  A CUDA graph capture makes
    them first (a capture must not upload or allocate them) and keeps
    them alive."""
    return bits_at._device_tables(device) + (_istep_table(device),
                                             _counter(device))


def _check_inputs(xr75p, budget, start, qss_lo, is_short, is_short_block,
                  width=None):
    if width is not None and not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"search: width {width} is not in 1..{MAX_WIDTH}")
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
            ST, n_bisect, max_steps, width):
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
        lut, hlen, istep, counter = device_buffers(dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp3_search(
                xr75p.data_ptr(), budget.data_ptr(), start.data_ptr(),
                None if qss_lo is None else qss_lo.data_ptr(),
                is_short.data_ptr(), is_short_block.data_ptr(),
                tab.data_ptr(), lut.data_ptr(), hlen.data_ptr(),
                istep.data_ptr(), int(ST["r0_pairs_short"]), int(walk),
                int(n_bisect), int(max_steps), int(width or 0), G,
                out.data_ptr(), counter.data_ptr(), stream)
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
                    n_bisect=8, qss_lo=None, width=None):
    """``loop.search_stepsize_plain`` in one launch per batch.

    xr75p (G, 576) float32 permuted |xr|^0.75; budget, qanf and qss_lo
    (optional) (G,) float32; is_short, is_short_block (G,) bool; ST the
    rate's ``device_tables``.  Inputs are checked first on every device.
    A CPU tensor then runs the plain version; a CUDA tensor launches K3
    (and counts it in ``search.launches``) or raises.  `width` (1 to
    MAX_WIDTH warps a granule) overrides the launch's pick: for tests and
    measurements; every width gives the same result."""
    dev = _check_inputs(xr75p, budget, qanf, qss_lo, is_short,
                        is_short_block, width)
    if dev.type == "cpu":
        return loop.search_stepsize_plain(xr75p, budget, qanf, is_short,
                                          is_short_block, ST,
                                          n_bisect=n_bisect, qss_lo=qss_lo)
    return _launch(False, xr75p, budget, qanf, qss_lo, is_short,
                   is_short_block, ST, n_bisect, 40, width)


def search_walk(xr75p, budget, start_qss, is_short, is_short_block, ST,
                max_steps=40, width=None):
    """``loop.search_walk_plain`` in one launch per batch; arguments and
    dispatch as ``search_stepsize``."""
    dev = _check_inputs(xr75p, budget, start_qss, None, is_short,
                        is_short_block, width)
    if dev.type == "cpu":
        return loop.search_walk_plain(xr75p, budget, start_qss, is_short,
                                      is_short_block, ST,
                                      max_steps=max_steps)
    return _launch(True, xr75p, budget, start_qss, None, is_short,
                   is_short_block, ST, 0, max_steps, width)

