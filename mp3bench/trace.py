"""Reading a torch.profiler Chrome trace, frozen for the benchmark.

``DEVICE_CATS``, ``LAUNCH_CATS`` and the launch-correlation rule (a
device event belongs to the host span that holds the call launching it)
are copied from ``mp3tpu_torch/tools/__init__.py`` and
``mp3tpu_torch/tools/trace_stages.py`` (``span_breakdown``, commit
8dfe798); the interval arithmetic (busy, idle and uncovered time,
gaps) is added here.  Later changes to the program do not reach it.
"""
import json

import numpy as np

#: the device work that every count here counts: kernels, copies and
#: memsets (a span's device-side range, "gpu_user_annotation", is none)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the benchmark's own spans (each job of the window) begin with this
OWN = "mp3bench."
#: the profiler's own ranges, one a step of its schedule: no program span
STEP = "ProfilerStep#"
#: a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 120


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals):
    return sum(e - s for s, e in union(intervals))


def gaps(busy, lo, hi):
    """The stretches of [lo, hi) outside the merged intervals `busy`."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class Trace:
    """A trace's events in microseconds: the benchmark's job spans, the
    program's spans on the jobs' thread, the device events with the
    time of the host call that launched each (None when the trace does
    not hold it)."""

    def __init__(self, path):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        ann = [e for e in events if e.get("cat") == "user_annotation"]
        self.jobs = sorted((e["ts"], e["ts"] + e["dur"]) for e in ann
                           if e["name"].startswith(OWN))
        tids = {e["tid"] for e in ann if e["name"].startswith(OWN)}
        self.spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                             for e in ann if e["tid"] in tids
                             and not e["name"].startswith((OWN, STEP))),
                            key=lambda s: s[1])
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})}
        self.device = [(e["name"], e["ts"], e["ts"] + e["dur"],
                        launch.get(e.get("args", {}).get("correlation")))
                       for e in events if e.get("cat") in DEVICE_CATS]
        self.lo = self.jobs[0][0] if self.jobs else 0.0
        self.hi = self.jobs[-1][1] if self.jobs else 0.0

    @property
    def window_us(self):
        return self.hi - self.lo

    def busy(self):
        """Merged device intervals inside the window."""
        return union(clip([(s, e) for _, s, e, _ in self.device],
                          self.lo, self.hi))

    def spans_named(self, names):
        return [(s, e) for n, s, e in self.spans if n in names]

    def host_us(self, names):
        """Host time covered by the spans of `names` (nested ones once)."""
        return covered(clip(self.spans_named(names), self.lo, self.hi))

    def device_us_launched_in(self, names):
        """Summed device time of the events whose launching call lies in
        a span of `names`."""
        iv = union(self.spans_named(names))
        starts = np.array([s for s, _ in iv])
        total = 0.0
        for _, s, e, t in self.device:
            if t is None or not len(iv):
                continue
            j = int(np.searchsorted(starts, t, side="right")) - 1
            if j >= 0 and t <= iv[j][1]:
                total += e - s
        return total

    def device_us_of(self, kernel_word):
        """Summed device time of the events whose name holds
        `kernel_word` (a kernel's name, e.g. "pack12_kernel")."""
        return sum(e - s for n, s, e, _ in self.device if kernel_word in n)

    def innermost_span(self, t):
        """The innermost program span holding host time t, or None."""
        best = None
        for n, s, e in self.spans:
            if s > t:
                break
            if e >= t and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else None

    def breakdown(self, top=10):
        """{"device_ops": [[kernel name (its first NAME_CHARS
        characters), device s]], "idle_gaps": [[the
        host's innermost span at the gap's start, or "outside every
        span", gap s]]}: the `top` of each by time."""
        by = {}
        for n, s, e, _ in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        g = sorted(gaps(self.busy(), self.lo, self.hi),
                   key=lambda se: se[0] - se[1])[:top]
        idle = [[self.innermost_span(s) or "outside every span",
                 (e - s) / 1e6] for s, e in g]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
                "idle_gaps": idle}
