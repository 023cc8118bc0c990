"""The frozen trace arithmetic on a hand-made trace: busy and idle time,
host time in spans and outside them, device time by launching span and
by kernel, and the breakdown."""
import json

import pytest

from mp3bench.trace import Trace

# us: one job 0-1000; the program's spans on its thread: A 100-400 with
# B 150-250 inside, C 600-700; a span on another thread and the
# profiler's step range are not counted
EVENTS = [
    dict(ph="X", cat="user_annotation", name="mp3bench.job", ts=0, dur=1000,
         tid=1),
    dict(ph="X", cat="user_annotation", name="A", ts=100, dur=300, tid=1),
    dict(ph="X", cat="user_annotation", name="B", ts=150, dur=100, tid=1),
    dict(ph="X", cat="user_annotation", name="C", ts=600, dur=100, tid=1),
    dict(ph="X", cat="user_annotation", name="D", ts=800, dur=100, tid=2),
    # the profiler's step range covers the job: no program span
    dict(ph="X", cat="user_annotation", name="ProfilerStep#3", ts=0,
         dur=1000, tid=1),
    # launches: two in B, one in C, one outside any span
    dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=160, dur=5,
         tid=1, args=dict(correlation=1)),
    dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=200, dur=5,
         tid=1, args=dict(correlation=2)),
    dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=650, dur=5,
         tid=1, args=dict(correlation=3)),
    dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=450, dur=5,
         tid=1, args=dict(correlation=4)),
    # device: 200-300 and 250-350 overlap; 700-750; a copy 500-520
    dict(ph="X", cat="kernel", name="void k3::search_kernel(int)", ts=200,
         dur=100, args=dict(correlation=1)),
    dict(ph="X", cat="kernel", name="void pack12_kernel(int)", ts=250,
         dur=100, args=dict(correlation=2)),
    dict(ph="X", cat="kernel", name="void pack12_kernel(int)", ts=700,
         dur=50, args=dict(correlation=3)),
    dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=500, dur=20,
         args=dict(correlation=4)),
    dict(ph="X", cat="gpu_user_annotation", name="A", ts=200, dur=500),
]


@pytest.fixture
def tr(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=EVENTS)))
    return Trace(str(p))


def test_window_busy_and_idle(tr):
    assert tr.window_us == 1000
    assert tr.busy() == [(200, 350), (500, 520), (700, 750)]
    assert sum(e - s for s, e in tr.busy()) == 220


def test_spans(tr):
    assert tr.host_us(["A", "B"]) == 300 and tr.host_us(["C"]) == 100
    assert tr.host_us(["D"]) == 0            # another thread
    assert tr.device_us_launched_in(["B"]) == 200
    assert tr.device_us_launched_in(["A"]) == 200
    assert tr.device_us_launched_in(["C"]) == 50
    assert tr.device_us_of("pack12_kernel") == 150
    assert tr.device_us_of("search_kernel") == 100


def test_metric_readers_on_the_trace(tr):
    from types import SimpleNamespace

    from mp3bench.harness import load_file
    ctx = SimpleNamespace(trace=tr, audio_min=0.5, jobs=2, counters={})
    idle = load_file("metrics", "device.idle_pct").read(ctx)
    assert idle == pytest.approx(78.0)
    # spans cover 100-400 and 600-700 of the 1000 us
    assert load_file("metrics", "host.unspanned_pct").read(ctx) == \
        pytest.approx(60.0)
    assert load_file("metrics", "k3.device_ms").read(ctx) == \
        pytest.approx(0.1 / 0.5)


def test_breakdown(tr):
    b = tr.breakdown()
    name, secs = b["device_ops"][0]
    assert name == "void pack12_kernel(int)" and secs == pytest.approx(150e-6)
    gaps = b["idle_gaps"]
    # 750-1000, 0-200 and 520-700 begin outside every span; 350-500
    # begins inside A
    assert [g[1] for g in gaps] == pytest.approx([250e-6, 200e-6, 180e-6,
                                                  150e-6])
    assert [g[0] for g in gaps] == ["outside every span",
                                    "outside every span",
                                    "outside every span", "A"]
