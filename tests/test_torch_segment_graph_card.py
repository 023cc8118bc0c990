"""The Layer III segment program as one CUDA graph on the card.

``Layer3SegmentEncoder.forward`` replays ``_segment`` -- the analysis,
the demand rate loop, K4's scan, the final budgets, the final rate loop
and the emission -- as one graph a key (stage "segment"), with the clip
length ``n_real`` an input of the graph.  Here it is held to
``encode_segment_staged`` (the staged graphs with the scan and budgets
between them) with torch.equal on every output at the main path's 512-
and 4096-lane segments, MPEG-1 and LSF, over a capture call, a replay
and a replay at another ``n_real``; on the bench plan's two 4096-lane
segments with the carry of the first fed to the second; and a whole
encode gives the yardstick form's bytes (``tools.yardstick_form``) with
stage "segment" replayed and no stage of the staged form.

A CUDA graph has no CPU mode, so these tests carry the `cuda` marker and
skip without a card.  This file imports no jax; run it on the card
without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_segment_graph_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import (PAYLOAD_WORDS, RELAX_DELTA, _Layer3Framing,
                                  _plan_segments, encode_layer3_fast,
                                  fill_granules)
from mp3tpu_torch.models import layer3
from mp3tpu_torch.ops import graphs, loop, resv, search
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools import yardstick_form
from test_torch_analysis_graph_card import (VERSIONS, assert_equal,
                                            clicked_signal, segment)

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch, card):
    """Empty graph caches of their own and zeroed graph counts."""
    for module, name in ((layer3, "SEGMENTS"), (layer3, "GRAPHS"),
                         (loop, "GRAPHS")):
        monkeypatch.setattr(module, name, graphs.GraphCache(16))
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    yield
    torch.cuda.synchronize()


def framing(version, card):
    v, sf, rate = VERSIONS[version]
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                        bitrate_kbps=128 if v == mpeg.MPEG1 else 64,
                        sample_rate_hz=rate)
    return _Layer3Framing(cfg, card), cfg, rate


def both(L3, blocks, fsm, size, n_real):
    """(forward's outputs, encode_segment_staged's) of one segment call
    of `L3`'s constants."""
    n_pad = blocks.shape[1] - 4
    args = (blocks, fsm, size, PAYLOAD_WORDS, L3.nch, L3.cap(n_pad), n_real,
            L3.mean_bits, L3.resv_max, L3.mode_gr, RELAX_DELTA)
    return L3.enc(*args), L3.enc.encode_segment_staged(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("S", [256, 2048], ids=["512lanes", "4096lanes"])
def test_one_graph_equals_the_staged_form(fresh, card, S, version):
    """A capture call, a replay on the same inputs and a replay on another
    segment at a shorter n_real: each torch.equal to the staged form on
    every output; one capture and two replays of stage "segment", no
    staged graph replayed by it; 7 K3 launches a rate loop and one K4
    launch a segment in each form, counted through the replays."""
    L3, _, rate = framing(version, card)
    pcm = clicked_signal(2.0 + S * 576 * 2 / rate, rate, S)
    fsm = torch.tensor([0, 2], dtype=torch.int32, device=card)
    calls = [(segment(pcm, S, 40, card), fsm, 0, S)] * 2 + [
        (segment(pcm, S, 40 + S // 2, card), fsm.flip(0), 1203, S - 18)]
    for blocks, f, size, n_real in calls:
        k3, k4 = search.launches, resv.launches
        got, ref = both(L3, blocks, f, size, n_real)
        assert (search.launches - k3, resv.launches - k4) == (28, 2)
        assert_equal(got, ref)
    assert (ref["block_type"] == 2).any()
    by_stage = graphs.by_stage()
    assert by_stage["segment"] == (1, 2)
    assert len(layer3.SEGMENTS) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
def test_carried_segments_equal_the_staged_form(fresh, card, version):
    """The bench plan's segments of a clip that gives two 4096-lane
    segments (60 s MPEG-1, 110 s LSF), each fed the carry (fsm_state,
    size) of the one before in each form: every output torch.equal, the
    plan's 4 segments on 2 keys."""
    L3, _, rate = framing(version, card)
    pcm = clicked_signal(60.0 if L3.mode_gr == 2 else 110.0, rate, 3)
    framed, nframes = L3.frame(pcm)
    G = nframes * L3.mode_gr
    plan = _plan_segments(G)
    assert len(plan) == 4 and plan[1][2] == plan[2][2] == 2048
    carry = {"one": (torch.zeros(2, dtype=torch.int32, device=card), 0),
             "staged": (torch.zeros(2, dtype=torch.int32, device=card), 0)}
    for pos, n_real, n_pad in plan:
        bl = np.zeros((L3.nch, 4 + n_pad, 576), np.int16)
        fill_granules(bl[:, :4 + n_real], framed, pos - 4)
        bl = torch.as_tensor(bl, device=card)
        args = (PAYLOAD_WORDS, L3.nch, L3.cap(n_pad), n_real, L3.mean_bits,
                L3.resv_max, L3.mode_gr, RELAX_DELTA)
        got = L3.enc(bl, *carry["one"], *args)
        ref = L3.enc.encode_segment_staged(bl, *carry["staged"], *args)
        assert_equal(got, ref)
        carry = {"one": (got["fsm_state"], got["size"]),
                 "staged": (ref["fsm_state"], ref["size"])}
    assert graphs.by_stage()["segment"] == (2, 2)
    assert len(layer3.SEGMENTS) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("version", VERSIONS)
def test_encode_equals_the_yardstick_form(fresh, card, version):
    """A 20 s encode gives the yardstick form's bytes, the second time
    with stage "segment" replayed and no graph of the staged form."""
    _, cfg, rate = framing(version, card)
    pcm = clicked_signal(20.0, rate, 7)
    with yardstick_form():
        ref = encode_layer3_fast(pcm, cfg, "cuda")
    assert graphs.by_stage()["segment"] == (0, 0)
    assert encode_layer3_fast(pcm, cfg, "cuda") == ref
    graphs.reset_counts()
    assert encode_layer3_fast(pcm, cfg, "cuda") == ref
    by_stage = graphs.by_stage()
    assert by_stage["segment"][1] > 0 and by_stage["segment"][0] == 0
    assert all(by_stage[s] == (0, 0) for s in graphs.SEGMENT_STAGES), \
        by_stage
