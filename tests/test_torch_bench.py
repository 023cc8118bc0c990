"""The port's benchmark tools, ``mp3tpu_torch.tools.bench`` and
``bench_corpus``, against the JAX package's ``bench.py`` and
``bench_corpus.py``: the same JSON line (plus ``device``) from the same
timings -- both clocks stubbed, so that the line is exact -- the same
signals and encode settings (the JAX scripts run with their encode
stubbed), and the timed streams equal to a direct encode of the same
signal.

The card test carries the `cuda` marker and skips without a card.  This
file imports the JAX package only inside the tests that need it, so the
card test runs on a machine without jax:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_bench.py
"""
import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench as jbench
import bench_corpus as jbench_corpus
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import encode_layer3_fast
from mp3tpu_torch.parallel.corpus import encode_corpus_batched
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools import bench, bench_corpus, signals
from mp3tpu_torch.tools.corpus_sweep import CORPUS_CFG, corpus

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_CFG = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                 sample_rate_hz=44100)


#: the five timed walls that the stub clock gives a bench script (s).
#: Both real-time factors below sit just past a step of vs_baseline's
#: rounding, so that a line computing it from the rounded value differs.
WALLS = (0.0137, 0.0117, 1 / 76.3121, 0.0123, 0.0142)
#: the real-time factor that the corpus encode reports to a corpus script
CORPUS_RT = 151.1843


def _clock_bench(monkeypatch, module):
    """The module's clock gives each timed encode its wall of WALLS."""
    ticks = iter([t for w in WALLS for t in (0.0, w)])
    monkeypatch.setattr(module, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))


def _clock_corpus(monkeypatch, module):
    """The module's corpus encode reports CORPUS_RT (the port's encode
    still runs; the JAX script's is the stub, which reports it)."""
    if module is bench_corpus:
        real = bench_corpus.encode_corpus_batched

        def encode(*args, **kwargs):
            outs, stats = real(*args, **kwargs)
            return outs, dict(stats, x_realtime=CORPUS_RT)
        monkeypatch.setattr(bench_corpus, "encode_corpus_batched", encode)


def _stub_bench(calls):
    def encode(pcm, cfg):
        calls.append((pcm, cfg))
        return b"\xff" * 2000
    return "mp3tpu.encoder", "encode_layer3_fast", encode


def _stub_corpus(calls):
    def encode(clips, kw, batch):
        calls.append((clips, kw, batch))
        return [b"\xff" * 2000] * len(clips), {"x_realtime": CORPUS_RT}
    return "mp3tpu.parallel.corpus", "encode_corpus_batched", encode


def _check_bench_calls(calls):
    """bench.py encoded the port's signal at the port's settings, once
    to warm up and five times timed."""
    pcm = signals.make_signal(1.0, 44100)
    assert len(calls) == 6
    for got, cfg in calls:
        assert got.dtype == pcm.dtype and np.array_equal(got, pcm)
        assert {k: getattr(cfg, k) for k in BENCH_CFG} == BENCH_CFG


def _check_corpus_calls(calls):
    """bench_corpus.py encoded the port's corpus at the port's settings:
    the first group to warm up, then the whole corpus."""
    clips = corpus(2, 1.0)
    assert [len(c) for c, _, _ in calls] == [1, 2]
    for got, kw, batch in calls:
        assert kw == CORPUS_CFG and batch == 1
        for (a, ra), (b, rb) in zip(got, clips):
            assert ra == rb and a.dtype == b.dtype and np.array_equal(a, b)


def _rt_bench():
    """The bench line's numbers for WALLS at 1 s: bench.py's formulas."""
    rt = 1.0 / sorted(WALLS)[2]
    return {"value": round(rt, 2),
            "vs_baseline": round(rt / jbench.BASELINE_RT, 3),
            "spread_x": [round(1.0 / max(WALLS), 1),
                         round(1.0 / min(WALLS), 1)]}


def _rt_corpus():
    """The corpus line's numbers for CORPUS_RT."""
    return {"value": round(CORPUS_RT, 2),
            "vs_baseline": round(CORPUS_RT / jbench.BASELINE_RT, 3)}


#: (port tool, JAX script, argv, the JAX script's stub, the stub clock,
#: check of its calls, the numbers its line must give)
TOOLS = {
    "bench": (bench, jbench, ["1"], _stub_bench, _clock_bench,
              _check_bench_calls, _rt_bench),
    "bench_corpus": (bench_corpus, jbench_corpus, ["2", "1", "1"],
                     _stub_corpus, _clock_corpus, _check_corpus_calls,
                     _rt_corpus),
}


def _line(capsys):
    out = capsys.readouterr().out
    assert out.count("\n") == 1, out
    return json.loads(out)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_json_line_matches_the_jax_script(name, tmp_path, monkeypatch,
                                          capsys):
    tool, script, argv, stub, clock, check, numbers = TOOLS[name]
    calls = []
    module, attr, encode = stub(calls)
    monkeypatch.setattr(importlib.import_module(module), attr, encode)
    clock(monkeypatch, script)
    clock(monkeypatch, tool)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    script.main()
    want = _line(capsys)
    check(calls)
    assert {k: want[k] for k in numbers()} == numbers()

    before = {f for f in os.listdir(REPO) if f.endswith(".json")}
    assert tool.main([*argv, "--device", "cpu"]) == 0
    got = _line(capsys)
    assert os.listdir(tmp_path) == []
    assert {f for f in os.listdir(REPO) if f.endswith(".json")} == before

    assert got == dict(want, device="cpu")
    assert list(got) == [*want, "device"]


def test_bench_stream_is_a_direct_encode():
    record, out = bench.run(1, "cpu")
    cfg = EncoderConfig(**BENCH_CFG)
    assert out == encode_layer3_fast(signals.make_signal(1, 44100), cfg,
                                     "cpu")
    assert record["value"] > 0 and record["device"] == "cpu"


def test_bench_corpus_streams_are_a_direct_encode():
    record, outs = bench_corpus.run(2, 1, 1, "cpu")
    want, _ = encode_corpus_batched(corpus(2, 1), CORPUS_CFG, "cpu",
                                    batch=1)
    assert len(outs) == 2 and outs == want
    assert record["value"] > 0 and record["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_module_refuses_cuda_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", f"mp3tpu_torch.tools.{name}", "--device",
         "cuda"], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr
    assert os.listdir(tmp_path) == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the encode runs K3, which has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bench_stream_on_the_card_is_a_direct_encode(card):
    record, out = bench.run(2, card)
    cfg = EncoderConfig(**BENCH_CFG)
    assert out == encode_layer3_fast(signals.make_signal(2, 44100), cfg,
                                     card)
    assert record["value"] > 0 and record["device"] != str(card)
