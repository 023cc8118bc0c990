"""The segment program's captured analysis and emission on the card.

``Layer3SegmentEncoder.analysis`` (the batched analysis of every lane,
one CUDA graph a key) against ``analysis_eager`` (lane by lane, op by
op), and ``encode_final`` (the emission and packing replayed after the
rate loop's last iteration) against ``encode_final_eager`` (op by op
after the loop): torch.equal on every output at the main path's 512- and
4096-lane segments, MPEG-1 and LSF, and at a corpus group's 32 lanes,
over a capture call, a replay and a call on other inputs of the key;
and a whole encode in the staged form (``tools.staged_form``) equal to
the yardstick form's bytes (``tools.yardstick_form``) with the analysis
and emission replayed.

A CUDA graph has no CPU mode, so these tests carry the `cuda` marker and
skip without a card.  This file imports no jax; run it on the card
without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_analysis_graph_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import encode_layer3_fast
from mp3tpu_torch.models import layer3
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import graphs, loop
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools import staged_form, yardstick_form
from mp3tpu_torch.tools.signals import make_clip, make_signal

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch, card):
    """Empty analysis and rate-loop caches of their own, zeroed counts."""
    monkeypatch.setattr(layer3, "GRAPHS", graphs.GraphCache(16))
    monkeypatch.setattr(loop, "GRAPHS", graphs.GraphCache(16))
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    yield
    torch.cuda.synchronize()


def clicked_signal(seconds, rate, seed):
    """The bench signal with a click every 0.7 s (transients: short
    blocks and the automaton's carry take part)."""
    pcm = make_signal(seconds, rate).astype(np.int32)
    rng = np.random.RandomState(seed)
    for pos in range(int(0.3 * rate), len(pcm) - 64, int(0.7 * rate)):
        pcm[pos:pos + 64] += rng.randint(-20000, 20000, (64, 2))
    return np.clip(pcm, -32768, 32767).astype(np.int16)


def segment(pcm, S, pos, card):
    """blocks_h4 (2, 4 + S, 576) of stereo (samples, 2) PCM at granule
    pos, as the encoder slices a segment, on the card."""
    G = len(pcm) // 576
    x = pcm[:G * 576].T.reshape(2, G, 576)
    bl = np.zeros((2, 4 + S, 576), np.int16)
    bl[:, :4] = x[:, pos - 4:pos]
    n = min(S, G - pos)
    bl[:, 4:4 + n] = x[:, pos:pos + n]
    return torch.as_tensor(bl, device=card)


def assert_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


VERSIONS = {"mpeg1": (mpeg.MPEG1, 0, 44100), "lsf": (mpeg.MPEG2_LSF, 1,
                                                      24000)}


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("S", [256, 2048], ids=["512lanes", "4096lanes"])
def test_analysis_graph_equals_per_lane(fresh, card, S, version):
    """A capture call, a replay on the same inputs and a replay on another
    segment of the key: each torch.equal to analysis_eager on every
    output (xr, pe, ratio_l, ratio_s, block_type, fsm_state, n_nonfinite,
    scfsi)."""
    v, sf, rate = VERSIONS[version]
    enc = Layer3SegmentEncoder(v, sf, card)
    pcm = clicked_signal(2.0 + S * 576 * 2 / rate, rate, S)
    fsm = torch.tensor([0, 2], dtype=torch.int32, device=card)
    calls = [(segment(pcm, S, 40, card), fsm)] * 2 + [
        (segment(pcm, S, 40 + S // 2, card), fsm.flip(0))]
    for blocks, f in calls:
        ref = enc.analysis_eager(blocks, f)
        assert_equal(enc.analysis(blocks, f), ref)
    assert (ref["block_type"] == 2).any()
    assert graphs.by_stage()["analysis"] == (1, 2)


@pytest.mark.cuda
def test_analysis_graph_at_a_corpus_groups_lanes(fresh, card):
    """A corpus group of 16 clips: 32 lanes of 1,024 granules."""
    enc = Layer3SegmentEncoder(mpeg.MPEG1, 0, card)
    clips = [make_clip(s, 10.0, 44100) for s in range(16)]
    bl = np.zeros((32, 4 + 1024, 576), np.int16)
    for b, pcm in enumerate(clips):
        G = pcm.shape[1] // 576
        bl[2 * b:2 * b + 2, 4:4 + G] = pcm[:, :G * 576].reshape(2, G, 576)
    blocks = torch.as_tensor(bl, device=card)
    fsm = torch.zeros(32, dtype=torch.int32, device=card)
    ref = enc.analysis_eager(blocks, fsm)
    for _ in range(2):
        assert_equal(enc.analysis(blocks, fsm), ref)
    assert graphs.by_stage()["analysis"] == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True], ids=["rows", "compacted"])
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("S", [256, 2048], ids=["512lanes", "4096lanes"])
def test_emission_graph_equals_eager(fresh, card, S, version, flat):
    """encode_final (the emission replayed after the rate loop) against
    encode_final_eager on a real segment's final encode: a capture call,
    a replay, and a replay at budgets cut further, each torch.equal on
    the side table and the payload."""
    v, sf, rate = VERSIONS[version]
    enc = Layer3SegmentEncoder(v, sf, card)
    pcm = clicked_signal(2.0 + S * 576 * 2 / rate, rate, S + 1)
    fsm = torch.zeros(2, dtype=torch.int32, device=card)
    ana = enc.analyze_demand_fused(segment(pcm, S, 40, card), fsm)
    p23 = ana["p23"].to(torch.float32)
    budget = torch.where(p23 > 300, torch.floor(p23 * 0.7), 4095.0)
    args = dict(xr=ana["xr"], ratio_l=ana["ratio_l"], ratio_s=ana["ratio_s"],
                block_type=ana["block_type"], scfsi=ana.get("scfsi"),
                sf_fix=ana.get("sf_fix"), nch=2, qss_lo=ana["qss"],
                payload_words=96, flat_cap=(2 * S * 128 if flat else None))
    for b in (budget, budget, torch.floor(budget * 0.8)):
        ref = enc.encode_final_eager(budget=b, **args)
        assert_equal(enc.encode_final(budget=b, **args), ref)
    assert graphs.by_stage()["emission"] == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
def test_encode_equals_the_yardstick_form(fresh, card, version):
    """A 20 s encode in the staged form (``encode_segment_staged``) gives
    the yardstick form's bytes, the second time with every stage of the
    staged form replayed."""
    v, sf, rate = VERSIONS[version]
    pcm = clicked_signal(20.0, rate, 7)

    def encode():
        cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                            bitrate_kbps=128 if v == mpeg.MPEG1 else 64,
                            sample_rate_hz=rate)
        return encode_layer3_fast(pcm, cfg, "cuda")

    with yardstick_form():
        ref = encode()
    assert graphs.by_stage()["analysis"] == (0, 0)
    # the staged form, whose analysis and emission graphs this file holds
    with staged_form():
        assert encode() == ref
        assert encode() == ref
    by_stage = graphs.by_stage()
    assert all(by_stage[s][1] > 0 for s in graphs.SEGMENT_STAGES), by_stage
