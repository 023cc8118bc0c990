"""The port's measurement and quality tools, each run as
``python -m mp3tpu_torch.tools.<name> [--device cuda|cpu] ...``:

- ``bench``: the headline, ``bench.py``'s Layer III real-time factor of
  the 60 s clip (median of 5) and its JSON line;
- ``bench_corpus``: ``bench_corpus.py``'s aggregate real-time factor of
  a corpus at one lane batch and its JSON line;
- ``quality``: the 15 decoded-SNR fixtures on the device, against the
  reference encoder's bars and through libmpg123;
- ``trace_stages``: the end-to-end wall, each segment stage in isolation,
  this card's link and launch costs, and optionally a trace;
- ``profile_encode``: the stage profile, matmul FLOPs and device idle
  share of the bench encode;
- ``corpus_sweep``: the corpus's aggregate real-time factor by lane
  batch.

Each runs on the card unless ``--device cpu`` is given (without a card
``--device cuda`` exits non-zero; there is no fall back to the CPU),
prints its report as JSON on stdout and writes a file only to a path it
is given.  ``signals`` holds the benchmark scripts' signals;
``yardstick_form`` swaps in the segment program's staged and op-by-op
forms (``staged_form`` the staged one alone), for
comparisons and counts that a replayed CUDA graph hides; ``host_waits``
counts the host's waits on the card as torch sees them.
"""
import collections
import contextlib
import math
import os
import subprocess
import sys
import threading
import time
import warnings

import torch

#: NVIDIA H100 SXM, data sheet: HBM rate, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: the device events that every count here counts, by their category in a
#: trace: kernels, copies and memsets.  A window with CPU activity also
#: records each record_function span's range on the device
#: ("gpu_user_annotation"), which is no device work of its own.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_or_exit(prog, device):
    """``resolve_device(device)``, or exit non-zero with the reason (a
    CUDA device was asked for and there is none)."""
    from .. import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        sys.exit(f"{prog}: {e}")


def describe(dev):
    """What a report ran on: for CUDA the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them (the power
    limit sets the card's speed under load), else the device."""
    if dev.type != "cuda":
        return str(dev)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def sync(dev):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_events(prof):
    """The device events of a finished torch.profiler window: [(category,
    start us, end us)] of its kernels, copies and memsets (DEVICE_CATS,
    the set that ``trace_stages.span_breakdown`` counts in a trace); the
    device-side ranges of record_function spans are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA \
                or e.is_user_annotation:
            continue
        cat = ("gpu_memcpy" if e.name.startswith("Memcpy") else
               "gpu_memset" if e.name.startswith("Memset") else "kernel")
        out.append((cat, e.time_range.start, e.time_range.end))
    return out


def profile_once(fn):
    """One fn() under torch.profiler's CUDA activity: (its device events
    as device_events gives them, device busy s, profiled wall s).  Busy
    is the union of the events' intervals; the wall is the host clock
    around fn and a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    busy_us, end = 0.0, -math.inf
    for _, s, e in sorted(events, key=lambda e: e[1:]):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return events, busy_us / 1e6, wall


@contextlib.contextmanager
def yardstick_form(rate_loop_eager=False):
    """Within the block the programs run their yardstick forms: the
    segment program in stages (``Layer3SegmentEncoder.forward`` as
    ``encode_segment_staged``), its analysis lane by lane
    (``analysis_eager``, the multi-rank path's ``clip._per_lane``), the
    Layer I/II analysis op by op (``layer12.analyze_frames_eager``) and
    the emission op by op (``encode_final_eager``), the rate loop still as
    CUDA graphs on the card (the form before the analysis and emission
    were captured); with `rate_loop_eager` the rate loop op by op too
    (``loop.outer_loop_eager``), so that no graph replays.  For
    measurement only: a replay runs no Python and dispatches no aten op
    that a counter or a swapped function could see."""
    from ..models.layer3 import Layer3SegmentEncoder as Enc
    from ..ops import layer12, loop
    from ..parallel import clip
    swaps = [(Enc, "forward", Enc.encode_segment_staged),
             (Enc, "analysis", Enc.analysis_eager),
             (Enc, "encode_final", Enc.encode_final_eager),
             (clip, "_lanes", clip._per_lane),
             (layer12, "analyze_frames", layer12.analyze_frames_eager)]
    if rate_loop_eager:
        swaps.append((loop, "outer_loop", loop.outer_loop_eager))
    with _swapped(swaps):
        yield


def staged_form():
    """Within the block the Layer III segment program runs in stages
    (``Layer3SegmentEncoder.forward`` as ``encode_segment_staged``: the
    analysis, rate-loop and emission graphs with the scan and the final
    budgets between them), every other program as the package runs it:
    the yardstick of the one graph, and the form in which a wrapped
    function of the segment program is called on every encode."""
    from ..models.layer3 import Layer3SegmentEncoder as Enc
    return _swapped([(Enc, "forward", Enc.encode_segment_staged)])


@contextlib.contextmanager
def _swapped(swaps):
    """Each (object, attribute, function) of `swaps` set within the block,
    and set back after it."""
    real = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    try:
        for obj, name, fn in swaps:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in real:
            setattr(obj, name, fn)


class _SyncLog:
    """The synchronizations that torch reports while ``host_waits`` runs,
    {"file:line kind": n}; ``counts`` is None when nothing counts, and
    ``trace_on`` says whether the GPU trace reports to it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.trace_on = False
        self.counts = None
        self.root = "."
        self.last = {}              # thread -> its last report, unpaired

    def note(self, source, kind):
        """A report from `source` ("trace" or "warning") of a `kind` of
        synchronization, made by the first line outside torch on the
        stack (``_outside_torch``).  A blocking copy or
        a stream synchronize is reported twice, a trace and, when the
        operation returns, a warning, from the same thread and line: the
        second report of such a pair is not counted again."""
        f = _outside_torch(sys._getframe(1))
        site = (f"{os.path.relpath(f.f_code.co_filename, self.root)}:"
                f"{f.f_lineno}")
        tid = threading.get_ident()
        with self.lock:
            if self.counts is None:
                return
            prev = self.last.pop(tid, None)
            if prev is not None and prev == ("trace" if source == "warning"
                                             else "warning", site):
                return
            self.counts[f"{site} {kind}"] += 1
            self.last[tid] = (source, site)


def _outside_torch(frame):
    """The first frame from `frame` outwards whose code is not torch's,
    the warnings module's or this module's: the line that asked torch for
    the operation."""
    inside = (os.path.dirname(torch.__file__) + os.sep,
              warnings.__file__, __file__)
    while frame.f_back is not None and \
            frame.f_code.co_filename.startswith(inside):
        frame = frame.f_back
    return frame


_SYNCS = _SyncLog()


def gpu_trace_on():
    """Turn torch's GPU trace on, as ``torch.cuda._sanitizer`` does, with
    callbacks for event, stream and device synchronizations that report
    to ``host_waits``; returns False if it was on already.  Once a
    process: the trace cannot be turned off, and from then on each
    allocation, free and event record of the CUDA caching allocator calls
    into Python."""
    import torch.cuda._gpu_trace as gpu_trace
    with _SYNCS.lock:
        if _SYNCS.trace_on:
            return False
        _SYNCS.trace_on = True

    def report(kind):
        def callback(*_):
            _SYNCS.note("trace", kind)
        return callback

    torch._C._activate_gpu_trace()
    gpu_trace.register_callback_for_event_synchronization(report("event"))
    gpu_trace.register_callback_for_stream_synchronization(report("stream"))
    gpu_trace.register_callback_for_device_synchronization(report("device"))
    return True


def host_waits(fn, root="."):
    """fn()'s result and the host's waits on the card in it, as torch
    reports them: {"file:line kind": n}, paths relative to `root`.  Two
    reports are read.  ``torch.cuda.set_sync_debug_mode("warn")`` warns
    about a synchronizing operation (a copy to the host, ``.item()``, a
    stream synchronize; kind "warned" when only it reports one).  torch's
    GPU trace reports event, stream and device synchronizations (kinds
    "event", "stream", "device"), which the debug mode does not warn
    about: ``CUDAEvent::synchronize`` never calls
    ``warn_or_error_on_sync``.  An operation that both report counts
    once.  The card is synchronized before fn runs, outside the count."""
    gpu_trace_on()
    torch.cuda.synchronize()

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchronizing CUDA operation" in str(message):
            _SYNCS.note("warning", "warned")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        with _SYNCS.lock:
            _SYNCS.counts, _SYNCS.root, _SYNCS.last = \
                collections.Counter(), root, {}
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            with _SYNCS.lock:
                counts, _SYNCS.counts = _SYNCS.counts, None
    return out, dict(counts)
