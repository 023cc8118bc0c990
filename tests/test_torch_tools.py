"""The port's tooling on the CPU at small sizes: ``runtime.profiling.trace``
and its named program spans, the trace's breakdown by span, the
benchmark signals, the best-lag SNR, and the tools
(``python -m mp3tpu_torch.tools.<name>``), which print JSON, write only
to a path they are given and refuse ``--device cuda`` without a card
(the benchmark tools' own tests are in tests/test_torch_bench.py)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_corpus
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.decoder import decode_mp3
from mp3tpu_torch.decoder.layer3 import snr_db
from mp3tpu_torch.encoder import encode_layer3_fast
from mp3tpu_torch.runtime.profiling import ON_RETRY, SPANS, trace
from mp3tpu_torch.runtime.wav import read_wav
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch import tools
from mp3tpu_torch.tools import bench as tbench
from mp3tpu_torch.tools import bench_corpus as tbench_corpus
from mp3tpu_torch.tools import (corpus_sweep, profile_encode, quality,
                                signals, trace_stages)
from test_conformance import _best_lag_snr

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = [quality, trace_stages, profile_encode, corpus_sweep, tbench,
         tbench_corpus]


def _cfg(rate=44100, kbps=128, mode=mpeg.MODE_STEREO):
    return EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                         sample_rate_hz=rate)


def test_trace_on_cpu_holds_every_span(tmp_path):
    pcm = signals.make_signal(1.0, 44100)
    plain = encode_layer3_fast(pcm, _cfg(), "cpu")
    with trace(str(tmp_path), "cpu") as prof:
        out = encode_layer3_fast(pcm, _cfg(), "cpu")
    assert out == plain
    assert "outer_loop" in {e.key for e in prof.key_averages()}
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    # one segment: its program, two rate loops, one assembly; its blocks
    # filled and uploaded (two upload spans); no re-encode
    assert {n: names.count(n) for n in SPANS} == dict(
        dict.fromkeys(SPANS, 1), outer_loop=2, upload=2,
        **dict.fromkeys(ON_RETRY, 0))
    bd = trace_stages.span_breakdown(str(tmp_path / "trace.json"))
    assert bd["device_events"] == 0 and bd["unlinked_events"] == 0
    seg = bd["spans"]["encode_segment_fused"]
    inner = sum(bd["spans"][n]["host_s"] for n in (
        "analyze_demand_fused", "scan_budgets", "encode_final"))
    assert seg["self_host_s"] == pytest.approx(seg["host_s"] - inner)


def test_trace_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(str(tmp_path), "cuda"):
            pass
    assert not (tmp_path / "trace.json").exists()


def test_span_breakdown_attributes_device_events(tmp_path):
    """A hand-made trace: two segments, a rate loop nested in the first,
    kernels launched inside and outside the spans, one kernel whose
    launching call the trace lacks."""
    def x(cat, name, ts, dur, **args):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)
    events = [
        x("user_annotation", "encode_segment_fused", 0, 100),
        x("user_annotation", "outer_loop", 10, 50),
        x("user_annotation", "encode_segment_fused", 200, 100),
        x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        x("cuda_driver", "cuLaunchKernel", 30, 1, correlation=3),
        x("cuda_runtime", "cudaMemcpyAsync", 250, 1, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 400, 1, correlation=5),
        x("cuda_runtime", "cudaMemcpyAsync", 420, 1, correlation=6),
        x("kernel", "elementwise", 50, 2, correlation=1),
        x("kernel", "(anonymous namespace)::bits_at_kernel(float4 const*)",
          60, 3, correlation=2),
        x("kernel", "(anonymous namespace)::bits_at_kernel(float4 const*)",
          70, 4, correlation=3),
        x("gpu_memcpy", "Memcpy DtoH", 260, 10, correlation=4),
        x("kernel", "void (anonymous namespace)::resv_walk_kernel<4>("
          "float const*)", 410, 1, correlation=5),
        x("kernel", "orphan", 500, 1, correlation=99),
        x("gpu_user_annotation", "encode_segment_fused", 50, 250,
          correlation=7),
        {"ph": "M", "name": "process_name", "args": {}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    bd = trace_stages.span_breakdown(str(path))
    seg, loop = bd["spans"]["encode_segment_fused"], bd["spans"]["outer_loop"]
    assert (seg["count"], loop["count"]) == (2, 1)
    assert seg["host_s"] == pytest.approx(200e-6)
    assert seg["self_host_s"] == pytest.approx(150e-6)
    assert (seg["device_events"], seg["self_device_events"]) == (4, 2)
    assert seg["device_s"] == pytest.approx(19e-6)
    assert seg["self_device_s"] == pytest.approx(12e-6)
    assert (loop["device_events"], loop["self_device_events"]) == (2, 2)
    assert loop["device_s"] == pytest.approx(7e-6)
    assert bd["device_events"] == 6 and bd["unlinked_events"] == 1
    assert bd["device_events_by_cat"] == {"kernel": 5, "gpu_memcpy": 1,
                                          "gpu_memset": 0}
    assert bd["copy_calls_without_event"] == 1
    assert bd["bits_at_kernel_events"] == 2
    assert bd["resv_kernel_events"] == 1
    assert bd["spans"]["fetch"]["count"] == 0


def test_device_events_count_the_trace_categories():
    """profile_once's events: kernels, copies and memsets by the trace's
    categories; neither a span's device-side range nor a host op."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, device_type=DeviceType.CUDA, annotation=False, t=0):
        return NS(name=name, device_type=device_type,
                  is_user_annotation=annotation,
                  time_range=NS(start=t, end=t + 1))
    prof = NS(events=lambda: [
        ev("void elementwise_kernel<128, 4>(int)", t=1),
        ev("Memcpy HtoD (Pageable -> Device)", t=2),
        ev("Memset (Device)", t=3),
        ev("(anonymous namespace)::search_kernel(Args)", t=4),
        ev("outer_loop", annotation=True, t=5),
        ev("aten::add", DeviceType.CPU, t=6),
        ev("outer_loop", DeviceType.CPU, annotation=True, t=7)])
    assert tools.device_events(prof) == [
        ("kernel", 1, 2), ("gpu_memcpy", 2, 3), ("gpu_memset", 3, 4),
        ("kernel", 4, 5)]
    assert set(tools.DEVICE_CATS) == {c for c, _, _ in
                                      tools.device_events(prof)}


@pytest.mark.parametrize("seconds,rate", [(1.0, 44100), (2.5, 24000)])
def test_signals_equal_the_benchmark_scripts(seconds, rate):
    a, b = signals.make_signal(seconds, rate), bench.make_signal(seconds, rate)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for seed in (0, 5, 31):
        a = signals.make_clip(seed, seconds, rate)
        b = bench_corpus.make_clip(seed, seconds, rate)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_best_lag_snr_equals_the_loop():
    rng = np.random.RandomState(11)
    for trial in range(6):
        ref = (rng.randn(3000 + 500 * trial) * 4000).astype(np.int16)
        lead = rng.randint(0, 1500)
        tail = rng.randint(0, 2500) - 1200
        dec = np.concatenate([rng.randn(lead) * 50,
                              ref + rng.randn(len(ref)) * 10 ** trial])
        dec = dec[:len(dec) + tail] if tail < 0 else np.concatenate(
            [dec, rng.randn(tail)])
        want = _best_lag_snr(ref, dec[:, None])
        assert quality.best_lag_snr(ref, dec) == pytest.approx(want,
                                                               abs=1e-9)
    assert quality.best_lag_snr(np.ones(500), np.ones(500)) == -99.0


def _run(tool, argv, cwd, monkeypatch, capsys):
    """tool.main(argv) from `cwd`; the parsed JSON it printed.  It must
    write no file into cwd and no top-level JSON file into the repo."""
    before = {f for f in os.listdir(REPO) if f.endswith(".json")}
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = tool.main(argv)
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert os.listdir(cwd) == []
    assert {f for f in os.listdir(REPO) if f.endswith(".json")} == before
    return report


def test_quality_tool_on_cpu(tmp_path, monkeypatch, capsys):
    names = ["sine_mono_64", "noise_mono_64"]
    out = tmp_path / "q.json"
    report = _run(quality, ["--device", "cpu", str(out), "--fixtures",
                            *names], tmp_path / "cwd", monkeypatch, capsys)
    with open(out) as f:
        assert json.load(f) == report
    # the keys of tools/quality_tpu.py's report (:85-88, :105-111)
    assert set(report) == {"backend", "device", "x64", "fixtures",
                           "all_pass"}
    assert (report["backend"], report["device"]) == ("cpu", "cpu")
    assert report["all_pass"] and list(report["fixtures"]) == names
    for name in names:
        fx = report["fixtures"][name]
        assert set(fx) == {"pass", "channels", "valid_cbr_grid",
                           "mpg123_snr_db"}
        assert fx["pass"] and fx["valid_cbr_grid"]
        pcm, rate = read_wav(os.path.join(REPO, "tests", "golden",
                                          f"{name}.wav"))
        dec, _ = decode_mp3(encode_layer3_fast(
            pcm[:, 0], _cfg(rate, 64, mpeg.MODE_MONO), "cpu"))
        snr = float(snr_db(pcm[:, 0].astype(np.float64), dec[:, 0]))
        ch = fx["channels"][0]
        assert set(ch) == {"snr_db", "ref_bar_db", "margin_db"}
        assert ch["snr_db"] == round(snr, 2)
        assert ch["margin_db"] == round(snr - ch["ref_bar_db"], 2)


def test_trace_stages_tool_on_cpu(tmp_path, monkeypatch, capsys):
    tdir = tmp_path / "trace"
    report = _run(trace_stages, ["--device", "cpu", "--seconds", "1",
                                 "--runs", "1", "--trace", str(tdir)],
                  tmp_path / "cwd", monkeypatch, capsys)
    assert os.listdir(tdir) == ["trace.json"]
    assert report["e2e_median_s"] > 0 and report["bytes"] > 0
    assert report["link"] is None and report["stage_device"] is None
    assert len(report["stage_isolated_s"]) == 4
    assert all(t > 0 for t in report["stage_isolated_s"].values())
    assert report["segments"] == len(report["plan"]) == 1
    spans = report["trace"]["spans"]
    assert [n for n in SPANS if not spans[n]["count"]] == list(ON_RETRY)


def test_profile_encode_tool_on_cpu(tmp_path, monkeypatch, capsys):
    record = _run(profile_encode, ["--device", "cpu", "--seconds", "1"],
                  tmp_path / "cwd", monkeypatch, capsys)
    assert record["backend"] == "cpu" and record["bytes"] > 0
    assert record["wall_s"] > 0 and record["flop_counter_flops"] > 0
    assert record["stages_s"] and all(t > 0
                                      for t in record["stages_s"].values())
    assert record["mfu_vs_fp32_peak"] is None
    assert record["idle_share"] is None and record["device_events"] is None
    assert record["meta"]["frames"] == 39


def test_corpus_sweep_tool_on_cpu(tmp_path, monkeypatch, capsys):
    report = _run(corpus_sweep, ["--device", "cpu", "--clips", "4",
                                 "--seconds", "1", "--batches", "1", "2",
                                 "--runs", "1", "--single-seconds", "1"],
                  tmp_path / "cwd", monkeypatch, capsys)
    assert [r["lane_batch"] for r in report["sweep"]] == [1, 2]
    assert report["lookahead_groups"] == 3
    for r in report["sweep"]:
        assert r["aggregate_x_realtime"] > 0 and len(r["walls_s"]) == 1
    assert report["best"] in report["sweep"]
    assert report["single_clip_x_realtime"] > 0


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.split(".")[-1])
def test_tools_refuse_cuda_without_a_card(tool, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        tool.main(["--device", "cuda"])
    assert "CUDA" in str(exc.value.code)
    assert os.listdir(tmp_path) == []


def test_tool_module_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mp3tpu_torch.tools.quality", "--device",
         "cuda"], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr
