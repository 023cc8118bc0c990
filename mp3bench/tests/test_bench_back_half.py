"""The readers of the Layer I/II back half's graph: host time in the
``_layer12_back`` spans per audio-minute and the back half's replays a
job, on a hand-made trace and counters; a program without the span or
the stage reads nothing."""
import json
from types import SimpleNamespace

import pytest

from mp3bench.harness import load_file
from mp3bench.trace import Trace


def x(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                tid=tid, args={})


# us: two jobs 0-1000 and 1000-2000; on their thread each holds
# analyze_frames and then _layer12_back (the first with an analyze_frames
# nested in it, counted once); another thread's span and one after the
# window are not counted
EVENTS = [
    x("mp3bench.job", 0, 1000), x("mp3bench.job", 1000, 1000),
    x("analyze_frames", 100, 50), x("_layer12_back", 200, 80),
    x("analyze_frames", 210, 30),
    x("analyze_frames", 1100, 50), x("_layer12_back", 1200, 40),
    x("_layer12_back", 300, 100, tid=2), x("_layer12_back", 2500, 50),
]


def ctx(tmp_path, events, counters, jobs=2, audio_min=0.5):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=events)))
    return SimpleNamespace(trace=Trace(str(p)), audio_min=audio_min,
                           jobs=jobs, counters=counters)


def read(name, c):
    return load_file("metrics", name).read(c)


def counts(replays):
    return {"l12_analysis": dict(captures=0, replays=2),
            "l12_back": dict(captures=0, replays=replays)}


def test_back_half_host_ms_per_audio_minute(tmp_path):
    c = ctx(tmp_path, EVENTS, counts(2))
    assert read("l12.back_replay_host_ms", c) == pytest.approx(0.12 / 0.5)


@pytest.mark.parametrize("replays,want", [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_back_half_replays_a_job(tmp_path, replays, want):
    c = ctx(tmp_path, EVENTS, counts(replays))
    assert read("l12.back_replays", c) == pytest.approx(want)


def test_a_program_without_the_back_half_graph_reads_nothing(tmp_path):
    """No ``_layer12_back`` span and no "l12_back" stage (the program
    before the back half was captured): both readers return None."""
    old = [e for e in EVENTS if e["name"] != "_layer12_back"]
    c = ctx(tmp_path, old, {"l12_analysis": dict(captures=0, replays=2)})
    assert read("l12.back_replay_host_ms", c) is None
    assert read("l12.back_replays", c) is None
    assert read("l12.back_replays", ctx(tmp_path, EVENTS, counts(2),
                                        jobs=0)) is None
