"""The readers of the program's host spans (framing, uploads, ``settle``
and its re-encodes, the Layer I/II framing) and of the idle time that no
span explains, on a hand-made trace; on a trace without those spans
each host-span reader returns nothing."""
import json
from types import SimpleNamespace

import pytest

from mp3bench.harness import load_file
from mp3bench.trace import Trace


def x(name, ts, dur, cat="user_annotation", tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                args=args)


# us: one job 0-1000; on its thread frame 50-250, upload 260-300, settle
# 400-600 holding run_final 450-550 with an upload 460-470 in it,
# dispatch_group.blocks 620-640, _layer12_frame 700-720; another thread's
# run_final and a run_final after the window are not counted
EVENTS = [
    x("mp3bench.job", 0, 1000),
    x("frame", 50, 200), x("upload", 260, 40),
    x("settle", 400, 200), x("run_final", 450, 100), x("upload", 460, 10),
    x("dispatch_group.blocks", 620, 20), x("_layer12_frame", 700, 20),
    x("run_final", 100, 50, tid=2), x("run_final", 1200, 50),
    # device: 300-350, 500-520 (inside settle), 800-900
    x("cudaLaunchKernel", 290, 5, cat="cuda_runtime", correlation=1),
    x("cudaLaunchKernel", 470, 5, cat="cuda_runtime", correlation=2),
    x("cudaMemcpyAsync", 790, 5, cat="cuda_runtime", correlation=3),
    x("k", 300, 50, cat="kernel", correlation=1),
    x("k", 500, 20, cat="kernel", correlation=2),
    x("Memcpy DtoH", 800, 100, cat="gpu_memcpy", correlation=3),
]


def ctx(tmp_path, events, audio_min=0.5):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=events)))
    return SimpleNamespace(trace=Trace(str(p)), audio_min=audio_min, jobs=1,
                           counters={})


def read(name, c):
    return load_file("metrics", name).read(c)


def test_host_spans_per_audio_minute(tmp_path):
    c = ctx(tmp_path, EVENTS)
    assert read("l3.framing_host_ms", c) == pytest.approx(0.2 / 0.5)
    # 40 + 10 us of uploads (one inside run_final) and 20 of blocks
    assert read("l3.upload_host_ms", c) == pytest.approx(0.07 / 0.5)
    assert read("l3.settle_host_ms", c) == pytest.approx(0.2 / 0.5)
    assert read("l12.framing_host_ms", c) == pytest.approx(0.02 / 0.5)


def test_reencodes_count_run_final_spans(tmp_path):
    assert read("l3.settle_reencodes", ctx(tmp_path, EVENTS)) == \
        pytest.approx(1 / 0.5)
    calm = [e for e in EVENTS if e["name"] != "run_final"]
    assert read("l3.settle_reencodes", ctx(tmp_path, calm)) == 0.0


def test_idle_time_no_span_explains(tmp_path):
    c = ctx(tmp_path, EVENTS)
    # busy 170 us, spans 480 us, both at once 20 us (inside settle): idle
    # and unspanned together 1000 - (170 + 480 - 20) = 370 us
    assert read("device.idle_unspanned_pct", c) == pytest.approx(37.0)
    assert read("device.idle_pct", c) == pytest.approx(83.0)
    assert read("host.unspanned_pct", c) == pytest.approx(52.0)
    no_device = [e for e in EVENTS if e["cat"] == "user_annotation"]
    assert read("device.idle_unspanned_pct", ctx(tmp_path, no_device)) \
        is None


def test_a_trace_without_the_spans_reads_nothing(tmp_path):
    """A program without these spans: each host-span reader returns
    None, and the idle share outside every span is all the idle time."""
    old = [e for e in EVENTS if e["cat"] != "user_annotation"
           or e["name"] == "mp3bench.job"] + [x("fetch", 300, 100)]
    c = ctx(tmp_path, old)
    for name in ("l3.framing_host_ms", "l3.upload_host_ms",
                 "l3.settle_host_ms", "l3.settle_reencodes",
                 "l12.framing_host_ms"):
        assert read(name, c) is None, name
    # fetch 300-400 holds 300-350; with 500-520 and 800-900: 220 us
    assert read("device.idle_unspanned_pct", c) == pytest.approx(78.0)
