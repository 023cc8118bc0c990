"""The Layer III segment program as one CUDA graph, checked on the CPU
(``models/layer3.py``, ``ops/graphs.py``).

On a CUDA tensor ``Layer3SegmentEncoder.forward`` replays ``_segment``
-- the batched analysis, the demand rate loop, the reservoir scan (K4),
the final budgets, the final rate loop and the emission -- as one graph a
key, with the carry and the clip length ``n_real`` inputs of the graph.
A capture records kernels, so what these tests hold is what a capture
needs of the Python, and what the one graph must give: ``_segment``
equals the staged form (``encode_segment_staged``, what the CPU runs)
bit for bit on every output, at 8 and 16 lanes, one and two channels,
MPEG-1 and LSF; under an aten-op log on "cpu" and "meta", its searches
and scan stubbed, it reads no device value on the host, builds no tensor
from host data and copies nothing between devices; its host side
(``_run_segment``, ``graphs.run``) with a stand-in capture equals the
staged form call after call on one key, at other clip lengths, with each
call's carry fed to the next, and no output lies in a replay's pool; K3
and K4 launches held by the graph count at each replay; an encode whose
segments run the one graph's host side gives the staged form's bytes
through a forced re-bucket and a forced guard retry (``settle`` re-encodes
from each segment's own outputs); ``_segment`` holds to the JAX package's
``encode_segment_fused``; and an encoder's tables are made once a
(version, rate, device).  The graph itself runs on the card
(tests/test_torch_segment_graph_card.py, chip_smoke.py phase 5c).
"""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.models import layer3 as jlayer3
from mp3tpu_torch import encoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.models import layer3
from mp3tpu_torch.models.layer3 import (Layer3SegmentEncoder,
                                        _segment_inputs, _segment_params)
from mp3tpu_torch.ops import graphs, loop, resv, search
from mp3tpu_torch.runtime.wav import read_wav
from mp3tpu_torch.tables import mpeg
from test_torch_analysis_graph import (LANES, VERSIONS, _assert_equal,
                                       pooled_stand_in, segment,
                                       shares_storage)
from test_torch_corpus_pipeline import _forced_retry
from test_torch_graph import HOST_DATA, HOST_READS, OpLog, _moved

torch.set_num_threads(1)

#: each version's (sample rate, kbps): low rates, so that the scan cuts
#: budgets below the demand and the final loop re-encodes
RATES = {"mpeg1": (44100, 48), "lsf": (22050, 24)}


def framing(version, nch):
    """The segment constants of `version` for nch channels
    (``encoder._Layer3Framing``)."""
    rate, kbps = RATES[version]
    return encoder._Layer3Framing(EncoderConfig(
        layer=3, mode=mpeg.MODE_STEREO if nch == 2 else mpeg.MODE_MONO,
        bitrate_kbps=kbps, sample_rate_hz=rate), "cpu")


def case(golden_dir, version, nch, S, n_real, size_in=300):
    """(framing, blocks_h4, fsm_init, size_in, the segment call's
    arguments after the carry) of nch channels of S granules."""
    L3 = framing(version, nch)
    blocks, fsm = segment(golden_dir, nch, S)
    rest = (encoder.PAYLOAD_WORDS, nch, L3.cap(S), n_real, L3.mean_bits,
            L3.resv_max, L3.mode_gr, encoder.RELAX_DELTA)
    return L3, blocks, fsm, size_in, rest


def params(rest):
    """``_segment_params`` of the arguments after the carry."""
    pw, nch, cap, _, mean_bits, resv_max, mode_gr, delta = rest
    return _segment_params(pw, cap, mean_bits, resv_max, mode_gr, delta,
                           nch)


def one_graph(enc, blocks, fsm, size, rest):
    """``_segment`` on ``forward``'s arguments."""
    return enc._segment(_segment_inputs(blocks, fsm, size, rest[3]),
                        *params(rest))


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("lanes", [8, 16])
def test_one_graph_body_equals_the_staged_form(golden_dir, version, nch,
                                               lanes):
    """``_segment`` == ``encode_segment_staged`` on every output, dtype
    and value, its last two granules bucket padding and a carried level
    in; the scan cut some budgets below the demand."""
    S = lanes // nch
    L3, blocks, fsm, size, rest = case(golden_dir, version, nch, S, S - 2)
    got = one_graph(L3.enc, blocks, fsm, size, rest)
    ref = L3.enc.encode_segment_staged(blocks, fsm, size, *rest)
    _assert_equal(got, ref)
    assert ("scfsi" in got) == (version == "mpeg1")
    assert got["side"].shape == (lanes, 19)
    assert (got["target"] < got["demand"]).any()


def _recorded(monkeypatch, fn):
    """fn()'s result and the results of the searches and scans it made, in
    their order: {"stepsize": [...], "walk": [...], "scan": [...]},
    cloned (a walk that takes no step returns its start, a tensor of the
    loop's state that later iterations write)."""
    got = {"stepsize": [], "walk": [], "scan": []}

    def keep(name, real):
        def run(*args, **kwargs):
            res = real(*args, **kwargs)
            got[name].append(tuple(
                {k: v.clone() for k, v in r.items()} if isinstance(r, dict)
                else r.clone() for r in res))
            return res
        return run

    with monkeypatch.context() as m:
        m.setattr(loop, "search_stepsize",
                  keep("stepsize", loop.search_stepsize))
        m.setattr(loop, "search_walk", keep("walk", loop.search_walk))
        m.setattr(resv, "scan_budgets", keep("scan", resv.scan_budgets))
        out = fn()
    return out, got


def _stubbed(monkeypatch, recorded, device):
    """The searches and the scan replaced by stubs that return the
    recorded results, moved to `device`, in their order."""
    queues = {k: [_moved(r, device) for r in v] for k, v in recorded.items()}
    for obj, name, kind in ((loop, "search_stepsize", "stepsize"),
                            (loop, "search_walk", "walk"),
                            (resv, "scan_budgets", "scan")):
        monkeypatch.setattr(obj, name,
                            lambda *a, _q=queues[kind], **k: _q.pop(0))
    return queues


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("version", VERSIONS)
def test_segment_is_capture_safe(golden_dir, monkeypatch, version, device):
    """``_segment`` under an aten-op log, its 2 stepsize searches, 12
    walks and its scan replaced by stubs that return the plain versions'
    results: no host read of a device value, no tensor from host data,
    every tensor of every op on the run's device (on "meta", whose values
    the host cannot read, as on the card); on the CPU the same outputs as
    the run it was recorded from."""
    L3, blocks, fsm, size, rest = case(golden_dir, version, 2, 8, 6)
    ref, recorded = _recorded(
        monkeypatch, lambda: one_graph(L3.enc, blocks, fsm, size, rest))
    assert [len(v) for v in recorded.values()] == [2, 12, 1]
    queues = _stubbed(monkeypatch, recorded, device)
    enc = Layer3SegmentEncoder(*VERSIONS[version], device)
    inputs = {k: v.to(device) for k, v in
              _segment_inputs(blocks, fsm, size, rest[3]).items()}
    with OpLog() as log:
        out = enc._segment(inputs, *params(rest))
    assert not any(queues.values())
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 500
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device.type == device for t in out.values())
    if device == "cpu":
        _assert_equal(out, ref)


@pytest.fixture
def segment_graphs(monkeypatch):
    """An empty segment cache of its own, and zeroed graph counts."""
    cache = graphs.GraphCache(4)
    monkeypatch.setattr(layer3, "SEGMENTS", cache)
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    return cache


def _run(enc, blocks, fsm, size, rest, record):
    """``forward``'s host side on the current device: (entry, dropped)."""
    return enc._run_segment(_segment_inputs(blocks, fsm, size, rest[3]),
                            params(rest), record)


@pytest.mark.parametrize("version", VERSIONS)
def test_captured_segment_equals_the_staged_form(golden_dir, segment_graphs,
                                                 version):
    """The one graph's host side with a stand-in capture, three calls on
    one key at n_real 16, 11 and 14, each fed the carry (fsm_state,
    size) that the call before left in the entry's static outputs: each
    call's results equal the staged form's, fed its own carry; none
    shares storage with a tensor its replay made (an output left in the
    graphs' pool would be overwritten by the next graph); the first
    call's clones outlive the later replays.  Another payload row is
    another key."""
    L3, _, _, _, rest = case(golden_dir, version, 2, 16, 16)
    pools = []
    record = pooled_stand_in(pools)
    calls = [(segment(golden_dir, 2, 16), 16),
             (segment(golden_dir, 2, 16, LANES[2:]), 11),
             (segment(golden_dir, 2, 16), 14)]
    carry = ref_carry = (torch.tensor([0, 2], dtype=torch.int32), 300)
    kept = []
    for (blocks, _), n_real in calls:
        args = rest[:3] + (n_real,) + rest[4:]
        entry, dropped = _run(L3.enc, blocks, carry[0], carry[1], args,
                              record)
        out = entry.outputs["segment"]
        ref = L3.enc.encode_segment_staged(blocks, *ref_carry, *args)
        _assert_equal(out, ref)
        if pools:
            assert not [k for k, v in out.items()
                        if shares_storage(v, pools[-1])]
        kept.append({k: v.clone() for k, v in out.items()})
        carry = out["fsm_state"], out["size"]
        ref_carry = ref["fsm_state"], ref["size"]
        assert dropped == []
    assert len(segment_graphs) == 1 and len(pools) == 2
    assert graphs.by_stage()["segment"] == (1, 2)
    assert not torch.equal(kept[0]["side"], kept[1]["side"])
    # the same blocks at another clip length and carry
    assert not torch.equal(kept[0]["side"], kept[2]["side"])
    blocks, _ = calls[0][0]
    _run(L3.enc, blocks, *carry, (64,) + rest[1:], record)
    assert len(segment_graphs) == 2


def test_replays_count_k3_and_k4(golden_dir, segment_graphs, monkeypatch):
    """K3 (14 a segment: 7 a rate loop) and K4 (1) counted as the
    wrappers launch them: the warm-up's counted, the capture's taken back
    out and held by the graph, and added again at each replay."""
    def counting(obj, name, module):
        real = getattr(obj, name)

        def run(*args, **kwargs):
            module.launches += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(obj, name, run)

    counting(loop, "search_stepsize", search)
    counting(loop, "search_walk", search)
    counting(resv, "scan_budgets", resv)
    monkeypatch.setattr(search, "launches", 0)
    monkeypatch.setattr(resv, "launches", 0)

    def record(fn):
        fn()                              # a capture makes the launches
        return SimpleNamespace(replay=lambda: None)

    L3, blocks, fsm, size, rest = case(golden_dir, "mpeg1", 2, 4, 4)
    entry, _ = _run(L3.enc, blocks, fsm, size, rest, record)
    assert (search.launches, resv.launches) == (14, 1)
    assert entry.held["segment"] == [14, 0, 1]
    for n in (1, 2):
        _run(L3.enc, blocks, fsm, size, rest, record)
        assert (search.launches, resv.launches) == (14 + 14 * n, 1 + n)
    assert graphs.by_stage()["segment"] == (1, 2)


def _one_graph_forward(pools):
    """``forward`` as on the card, on the CPU: the one graph's host side
    with a stand-in capture, the caller keeping clones."""
    def forward(self, blocks_h4, fsm_init, size_in, payload_words, nch,
                flat_cap, n_real, mean_bits, resv_max, mode_gr, delta):
        entry, _ = _run(self, blocks_h4, fsm_init, size_in,
                        (payload_words, nch, flat_cap, n_real, mean_bits,
                         resv_max, mode_gr, delta), pooled_stand_in(pools))
        return {k: v.clone() for k, v in entry.outputs["segment"].items()}
    return forward


@pytest.mark.parametrize("path", ["rebucket", "guard"])
def test_retries_give_the_staged_forms_bytes(golden_dir, segment_graphs,
                                             monkeypatch, path):
    """A 1 s stereo encode at 16-granule segments (one key, five
    segments) whose segments run the one graph's host side: a payload row
    too narrow (pw 8: re-bucketed wider) and a guard retry forced on the
    first guard call each re-encode every segment from its own outputs
    and give the staged form's bytes under the same retry."""
    pcm, _ = read_wav(os.path.join(golden_dir, "noise_st_128.wav"))
    pcm = pcm[:44100]
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    pw = 8 if path == "rebucket" else encoder.PAYLOAD_WORDS
    outs, retries = [], []
    for form in ("staged", "one graph"):
        with monkeypatch.context() as m:
            if path == "guard":
                seen = _forced_retry(m)
            if form == "one graph":
                pools = []
                m.setattr(Layer3SegmentEncoder, "forward",
                          _one_graph_forward(pools))
            r0 = encoder.retry_fetches
            outs.append(encoder.encode_layer3_fast(pcm, cfg, "cpu",
                                                   chunk=16, pw=pw))
            retries.append(encoder.retry_fetches - r0)
            if path == "guard":
                assert len(seen) == 2, seen       # the forced call, then
                                                  # the retry's
    assert outs[0] == outs[1]
    assert retries[0] == retries[1] >= 2
    assert len(segment_graphs) == 1 and len(pools) >= 4


def test_segment_holds_to_jax(golden_dir):
    """``_segment`` against the JAX package's ``encode_segment_fused`` on
    a stereo 16-granule segment with transients, the last two granules
    padding and a carried level: the carry exact, and the integer outputs
    of what the stream carries (the side-info row, the target, the block
    type) identical on at least 95% of the granules, as
    tests/test_torch_loop.py holds the rate loop.  The demand encode's
    part2_3_length differs here by 1-2 bits on 4 of the 32 granules (a
    quantized line flipped by float32 round-off in two libraries, as
    tests/test_torch_layer3.py finds): it is held within 2 bits a granule
    and 0.1% in total."""
    L3, blocks, fsm, size, rest = case(golden_dir, "mpeg1", 2, 16, 14,
                                       size_in=800)
    pw, nch, cap, n_real, mean_bits, resv_max, mode_gr, delta = rest
    got = one_graph(L3.enc, blocks, fsm, size, rest)
    ref = jlayer3.encode_segment_fused(
        jnp.asarray(blocks.numpy()), jnp.asarray(fsm.numpy()),
        jnp.int32(size), mpeg.MPEG1, 0, 44100.0, pw, nch, cap, n_real,
        mean_bits, resv_max, mode_gr, delta)
    for k in ("fsm_state", "size"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())
    G = 32
    rows = {k: (np.asarray(ref[k], np.int64).reshape(G, -1),
                got[k].numpy().astype(np.int64).reshape(G, -1))
            for k in ("side", "target", "block_type", "demand")}
    same = np.all([(a == b).all(axis=1) for k, (a, b) in rows.items()
                   if k != "demand"], axis=0)
    assert same.mean() >= 0.95, same.mean()
    assert (got["block_type"] == 2).any()
    a, b = rows["demand"]
    assert np.abs(a - b).max() <= 2
    assert abs(int(a.sum()) - int(b.sum())) <= 0.001 * a.sum()


def test_a_warm_encode_hashes_no_table(monkeypatch):
    """A second encode of a rate, as phase 5c profiles one on the card,
    calls ``graphs.fingerprint`` no time: its encoder takes the tables
    made once (``layer3.rate_tables``)."""
    pcm = np.zeros((4 * 1152, 2), np.int16)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=32000)
    first = encoder.encode_layer3_fast(pcm, cfg, "cpu")
    calls = []
    real = graphs.fingerprint
    monkeypatch.setattr(graphs, "fingerprint",
                        lambda arrays: calls.append(1) or real(arrays))
    assert encoder.encode_layer3_fast(pcm, cfg, "cpu") == first
    assert calls == []


def test_tables_are_made_once(monkeypatch):
    """Two encoders of one (version, rate, "cpu") share every table
    tensor, and the second makes and hashes none
    (``graphs.fingerprint``); another rate has its own."""
    a = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    calls = []
    real = graphs.fingerprint
    monkeypatch.setattr(graphs, "fingerprint",
                        lambda arrays: calls.append(1) or real(arrays))
    b = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    assert calls == []
    for group in ("st", "psy", "dsp", "bits", "l3"):
        ta, tb = a.tables(group), b.tables(group)
        assert ta.keys() == tb.keys()
        assert all(ta[k] is tb[k] for k in ta
                   if isinstance(ta[k], torch.Tensor)), group
    assert Layer3SegmentEncoder(mpeg.MPEG1, 1, "cpu").tables("psy")[
        "part_l"] is not a.tables("psy")["part_l"]
