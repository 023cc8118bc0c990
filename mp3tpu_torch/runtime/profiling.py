"""Lightweight per-stage wall-clock profiling for the encode pipelines.

The reference has no profiling at all (SURVEY.md section 5.1 -- only a
compile-time PERFORM frame logger, loop.c:34-47).  Here every fast-path
encode can record a stage breakdown; `from_env()` is controlled by the
MP3TPU_PROFILE env var, or a Profiler is passed explicitly.  For deep
dives, `trace()` wraps torch.profiler for a device trace viewable in
Perfetto or chrome://tracing.

In a jax.profiler trace each jitted program carries its name; the eager
port's encode is some 17k unnamed launches instead.  `span` gives the
port's counterparts of those programs the JAX names (``SPANS``) as
torch.profiler record_function scopes, one per stage call (never per
bit evaluation), so that a trace groups every launch under the program
it belongs to.
"""
import contextlib
import functools
import json
import os
import time

import torch

#: the named program spans of a Layer III encode, in the JAX package's
#: program names; "native assembly" is the host frame loop
SPANS = ("encode_segment_fused", "analyze_demand_fused", "encode_final",
         "pack_state", "outer_loop", "scan_budgets", "granule_payload",
         "compact_payload", "fetch", "native assembly")


class Profiler:
    """Accumulates named stage durations (seconds) for one encode."""

    def __init__(self):
        self.stages = {}
        self.meta = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def total(self):
        return time.perf_counter() - self._t0

    def report(self):
        lines = [f"total {self.total()*1000:8.1f} ms"]
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:32s} {v*1000:8.1f} ms")
        return "\n".join(lines)

    def to_json(self):
        return json.dumps({"total_s": self.total(),
                           "stages_s": self.stages, "meta": self.meta})


class _Null:
    """No-op stage sink; still carries per-encode `meta` metrics (the
    encode paths always fill frames/bytes/bitrate/recovery counters,
    SURVEY.md section 5.5 -- the reference only printfs)."""

    def __init__(self):
        self.meta = {}

    @contextlib.contextmanager
    def stage(self, name):
        yield


NULL = _Null()


def from_env():
    """A Profiler if MP3TPU_PROFILE is set, else a fresh no-op sink
    (fresh so `meta` never leaks between encodes)."""
    return Profiler() if os.environ.get("MP3TPU_PROFILE") else _Null()


def span(name):
    """Decorator: while a torch.profiler runs, run the function inside a
    ``record_function`` scope `name` (one of ``SPANS``); otherwise call
    it as it is, so that an encode outside a trace touches no profiler
    machinery."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def trace(logdir, device):
    """torch.profiler trace around a code block; yields the profiler
    (``key_averages()``, ``events()``) and on exit writes the
    Chrome/Perfetto trace ``trace.json`` into `logdir`.

    device "cuda": CPU and CUDA activities (raises without a card; the
    device is synchronized before the trace stops, so that every launch
    of the block is recorded); "cpu": the CPU activity only."""
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
