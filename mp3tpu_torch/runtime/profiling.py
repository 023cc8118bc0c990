"""Profiling of the encode pipelines: named spans on torch.profiler's
clock, and the per-encode metrics sink.

The reference has no profiling at all (SURVEY.md section 5.1 -- only a
compile-time PERFORM frame logger, loop.c:34-47).  In a jax.profiler
trace each jitted program carries its name; the port's encode is
thousands of unnamed launches and CUDA graph replays instead.  `scope`
and `span` name them: while a torch.profiler runs, a record_function
scope, so that the span lands in the same trace as the kernels and
copies it launches, on the same clock; otherwise nothing.  ``SPANS``,
``SPANS_CORPUS``, ``SPANS_SHARDED`` and ``SPANS_L12`` list every name:
the programs in the JAX names, once a stage call (never a bit
evaluation), and the host work around them, once a segment or a clip
at most (never a granule, frame or lane).  `trace()` wraps
torch.profiler for such a trace, viewable in Perfetto or
chrome://tracing.

`Profiler`, `_Null`, `NULL` and `from_env` are copies of the JAX
package's stage sink (MP3TPU_PROFILE); the port's encodes fill only its
`meta` (frames, bytes, bitrate, recovery counters) and time their
stages with spans instead.
"""
import contextlib
import functools
import json
import os
import time

import torch

#: the named spans of a Layer III encode: the programs, in the JAX
#: package's program names ("native assembly" is the host frame loop),
#: then the host work around them, named after the port's functions (an
#: inline block ``<function>.<what>``):
#:
#: - ``_Layer3Framing``: the config, bit budget and segment encoder made
#:   for each encode;
#: - ``frame``: the PCM as (nch, n) int16 -- the orientation and the
#:   checks, and for input that is not int16 the float32 sanitizing
#:   (``nan_to_num``, the clip); once a clip;
#: - ``upload``: a host copy into a pinned buffer and its queued upload
#:   (a segment's blocks are filled from the clips in one span and
#:   uploaded in ``_Layer3Framing.segment``'s; ``run_final``'s budget
#:   rows);
#: - ``fetch_async``: the flatten, cast and queued download of results;
#: - ``settle``: the payload and reservoir guards on the downloaded p23,
#:   with everything below: ``_stitch_flat`` (the payloads stitched for
#:   the assembler) and ``run_final``, each one re-encode with its fetch,
#:   inside a span of its cause (``ON_RETRY``): ``rebucket`` (a granule
#:   past its payload row) or ``guard_retry`` (an overdraw that the
#:   reservoir guard found), the first of them also holding the fetch of
#:   the scan's target and demand;
#: - ``scfsi_frames``: the frames' scfsi flags for the assembler;
#: - ``NativeAssembler``, ``NativeAssembler.finish``: the assembler's
#:   construction and its flush (a stream window's ``drain`` too), beside
#:   ``native assembly``.
SPANS = ("encode_segment_fused", "analyze_demand_fused", "encode_final",
         "pack_state", "outer_loop", "scan_budgets", "granule_payload",
         "compact_payload", "fetch", "native assembly", "_Layer3Framing",
         "frame", "upload", "fetch_async", "settle", "_stitch_flat",
         "run_final", "rebucket", "guard_retry", "scfsi_frames",
         "NativeAssembler", "NativeAssembler.finish")
#: the spans of ``SPANS`` that open only when ``settle`` re-encodes: none
#: in an encode whose first final encode passes both guards
ON_RETRY = ("run_final", "rebucket", "guard_retry")
#: the corpus's own host work (``parallel/corpus.py``), around the spans
#: of ``SPANS``: ``_plan_budgets_corpus``, a group's budget rows around
#: its batched scan; ``_clip_records``, a clip's lanes cut out of its
#: group's results, once a clip
SPANS_CORPUS = ("_plan_budgets_corpus", "_clip_records")
#: the multi-rank clip's stages (``parallel/clip.py``), in the JAX
#: package's stage labels (``mp3tpu/parallel/clip.py:231-282``): the
#: analysis with its gather and download, the final encode with its own,
#: and each guard retry's
SPANS_SHARDED = ("sharded analyze+demand", "sharded final encode",
                 "sharded final retry")
#: the named spans of a Layer I/II encode: the programs in the JAX
#: package's function names (``mp3tpu/encoder.py:729``) -- the joint
#: decision runs inside K5 (or its plain version), under
#: ``greedy_allocation`` -- then the host work around
#: them: ``_layer12_frame`` (the PCM copied once into the pinned buffer
#: of (nch, F * spf) that is uploaded, int16 kept), ``upload`` (that
#: buffer's queued upload; psy model 1's SMR through a pinned buffer of
#: its own), ``_layer12_back`` (the back half, from the analysis outputs to
#: K6's buffer: op by op, around the spans of the SMR, K5, the quantizers,
#: the marshalling and K6; on a CUDA device with psy model 2 the back
#: half's graph replayed and K6's buffer copied out, after the analysis'
#: span), ``_layer12_back.smr`` (the SMR and scfsi stacked for K5),
#: ``_layer12_quantize`` (the joint samples chosen above jsbound and the
#: channels' codes stacked, around ``quantize_l1`` / ``quantize_l2``) and
#: ``_fetch_frames`` (the download's wait in ``fetch``, K6's status
#: checked and the frames' bytes)
SPANS_L12 = ("analyze_frames", "greedy_allocation", "quantize_l1",
             "quantize_l2", "_marshal_layer12", "pack_elements", "fetch",
             "_layer12_frame", "upload", "_layer12_back",
             "_layer12_back.smr", "_layer12_quantize", "_fetch_frames")
#: on a CUDA device the segment program replays one graph inside the span
#: encode_segment_fused, and in its staged form the emission and packing
#: replay one graph inside the span granule_payload (``ops/graphs.py``):
#: the spans of the programs each covers then show only where it is
#: captured or runs op by op
REPLAY_COVERS = {"encode_segment_fused": ("analyze_demand_fused",
                                          "outer_loop", "scan_budgets",
                                          "encode_final", "granule_payload",
                                          "compact_payload", "pack_state"),
                 "granule_payload": ("compact_payload", "pack_state")}


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


@contextlib.contextmanager
def scope(name):
    """While a torch.profiler runs, a ``record_function`` scope `name`
    (one of ``SPANS``, ``SPANS_CORPUS``, ``SPANS_SHARDED`` or
    ``SPANS_L12``) around the block; otherwise nothing, so that an
    encode outside a trace touches no profiler machinery."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


def span(name):
    """Decorator: the function runs inside ``scope(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with scope(name):
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
