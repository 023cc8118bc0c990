"""The cell ``l3-lsf-24k-64k.podcast`` (MPEG-2 LSF Layer III, 24 kHz,
64 kbps, stereo; spoken-word episodes through ``encode_layer3_fast``):
the readers of ``settle``'s re-encodes on a hand-made trace that holds
them inside the spans of their causes, and the cell on the CPU at a tiny
size -- correct as the program runs it, not correct with a segment
call's outputs left stale or with K3's stepsize searches held to nine
tenths of each granule's budget."""
import json
from types import SimpleNamespace

import pytest

from mp3bench import harness
from mp3bench.trace import Trace
from test_bench_faults import (every_frame, stale_segment_outputs,
                               stepsize_searches_coarser)

CELL = "l3-lsf-24k-64k.podcast"
CAUSES = ("rebucket", "guard_retry")


def x(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                tid=tid, args={})


# us: jobs 0-1000 and 1000-2000 on thread 1.  The first job's settle
# 100-500 holds a guard_retry 200-400 (its run_final 250-390, an upload
# in that); the second's settle 1100-1980 holds a rebucket 1150-1250 and
# two guard retries, 1300-1500 and 1600-1950, each with its run_final.
# Another thread's spans, and a settle with its re-encode after the
# window's last job, are not counted.
EVENTS = [
    x("mp3bench.job", 0, 1000), x("mp3bench.job", 1000, 1000),
    x("settle", 100, 400), x("guard_retry", 200, 200),
    x("run_final", 250, 140), x("upload", 260, 10),
    x("settle", 1100, 880), x("rebucket", 1150, 100),
    x("run_final", 1160, 80), x("guard_retry", 1300, 200),
    x("run_final", 1310, 180), x("guard_retry", 1600, 350),
    x("run_final", 1610, 330),
    x("guard_retry", 300, 100, tid=2), x("run_final", 310, 80, tid=2),
    x("settle", 2100, 300), x("guard_retry", 2150, 100),
    x("run_final", 2160, 80),
]


def ctx(tmp_path, events, audio_min=0.5):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(traceEvents=events)))
    return SimpleNamespace(trace=Trace(str(p)), audio_min=audio_min, jobs=2,
                           counters={})


def read(name, c):
    return harness.load_file("metrics", name).read(c)


def test_settle_readers_count_each_reencode_once(tmp_path):
    """The cell's re-encodes, a re-bucket and three guard retries on the
    jobs' thread inside the window, each a ``run_final`` inside a span
    of its cause: counted once each, and ``settle``'s time with them."""
    c = ctx(tmp_path, EVENTS)
    assert read("l3.settle_reencodes", c) == pytest.approx(4 / 0.5)
    # 400 + 880 us of settle, the nested spans counted once
    assert read("l3.settle_host_ms", c) == pytest.approx(1.28 / 0.5)


@pytest.mark.parametrize("name", ["l3.settle_reencodes",
                                  "l3.settle_host_ms"])
def test_the_cause_spans_move_no_reading(tmp_path, name):
    """``rebucket`` and ``guard_retry`` wrap the re-encodes that were
    there before them: without them each reader reads the same."""
    bare = [e for e in EVENTS if e["name"] not in CAUSES]
    assert read(name, ctx(tmp_path, EVENTS)) == \
        read(name, ctx(tmp_path, bare))


def run(edit):
    return harness.run(CELL, 2 ** 31 + 29, 0.5, False, device="cpu",
                       edit=edit)


def short_segments(traffic, config):
    """The tiny cell at chunk 64, every frame checked: several segments
    a clip, so that a segment's outputs matter."""
    every_frame(traffic, config)
    traffic["args"] = {"chunk": 64}


def test_the_cell_is_lsf_and_correct():
    r = run(short_segments)
    assert r["correct"] and r["failed"] == 0
    assert {n: v["value"] for n, v in r["check"].items()
            if n in ("bad_frames", "silenced_pct")} == \
        dict(bad_frames=0, silenced_pct=0.0)
    config = harness.cell(harness.spec(), CELL)[1]
    assert (config["sample_rate_hz"], config["bitrate_kbps"]) == (24000, 64)


def test_stale_segment_outputs_are_not_correct(monkeypatch):
    stale_segment_outputs(monkeypatch)
    assert not run(short_segments)["correct"]


def test_k3_at_nine_tenths_is_not_correct(monkeypatch):
    stepsize_searches_coarser(monkeypatch)
    r = run(every_frame)
    assert not r["correct"]
    assert r["check"]["unspent_pct"]["value"] > \
        r["check"]["unspent_pct"]["limit"]
