"""Lightweight per-stage wall-clock profiling for the encode pipelines.

The reference has no profiling at all (SURVEY.md section 5.1 -- only a
compile-time PERFORM frame logger, loop.c:34-47).  Here every fast-path
encode can record a stage breakdown; `from_env()` is controlled by the
MP3TPU_PROFILE env var, or a Profiler is passed explicitly.
"""
import contextlib
import json
import os
import time


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
