"""The corpus's group lookahead and the queued downloads on the card
(``parallel/corpus.py`` ``encode_corpus_batched(lookahead=)``,
``encoder.py`` ``_Layer3Framing.fetch_async`` and ``Download.wait``).

On the card a download is a copy into pinned memory on the copy stream,
and a group's host tail runs while later groups' device work is queued.
Reading a pinned buffer before its copy has run would give other bytes
and no error, which the CPU tests cannot show; so here every clip's
stream at lookahead 3 must equal the in-order form's (lookahead 0), a
forced guard retry included, the host may wait only where the port
counts a fetch (torch's sync debug mode and its GPU trace together), the
destination must be pinned and the source marked as in use on the copy
stream, and a download read before its copy has completed must raise.

These tests carry the `cuda` marker and skip without a card
(tests/test_torch_corpus_pipeline.py holds the same on the CPU).  This
file imports no jax; run it on the card without the repository's
conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_corpus_pipeline_card.py
"""
import os

import numpy as np
import pytest
import torch

from mp3tpu_torch import encoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.parallel import corpus
from mp3tpu_torch.tools import host_waits
from mp3tpu_torch.tools.corpus_sweep import CORPUS_CFG, RATE
from mp3tpu_torch.tools.corpus_sweep import corpus as make_corpus

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: six stereo 44.1 kHz clips of 3 s (bench_corpus.py's signals)
CLIPS, SECONDS = 6, 3.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream and pinned "
                    "memory have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def clips():
    return make_corpus(CLIPS, SECONDS)


def _encode(clips, dev, batch, lookahead):
    return corpus.encode_corpus_batched(clips, CORPUS_CFG, dev, batch=batch,
                                        lookahead=lookahead)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_lookahead_3_gives_the_in_order_bytes(card, clips, batch):
    """Every clip's stream at lookahead 3 equals lookahead 0's, on a
    capture run and on a replay run."""
    want = _encode(clips, card, batch, 0)
    assert len(want) == CLIPS and all(len(o) > 1000 for o in want)
    for _ in range(2):
        assert _encode(clips, card, batch, 3) == want


@pytest.mark.cuda
def test_a_forced_retry_in_a_pipelined_group(card, clips, monkeypatch):
    """A guard retry forced on group 0's clip: its re-encode queues
    behind the groups in flight, and the bytes and fetches equal the
    in-order run's under the same retry."""
    real = encoder.resv_guard
    got = {}
    for lookahead in (0, 3):
        seen = []

        def guard(p23, nframes, nch, mean_bits, resv_max, mode_gr,
                  size=None):
            res = real(p23, nframes, nch, mean_bits, resv_max, mode_gr,
                       size=size)
            seen.append(res[0])
            return (True,) + tuple(res[1:]) if len(seen) == 1 else res

        monkeypatch.setattr(encoder, "resv_guard", guard)
        f0, r0 = encoder.fetches, encoder.retry_fetches
        outs = _encode(clips, card, 1, lookahead)
        got[lookahead] = (outs, encoder.fetches - f0,
                          encoder.retry_fetches - r0)
    assert got[3] == got[0]
    assert got[3][1:] == (CLIPS + 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("lookahead", [0, 3])
def test_no_hidden_wait(card, clips, lookahead):
    """A warm run at lane batch 2: torch reports exactly one
    synchronization a group (an event synchronization at the download's
    wait) and the port counts one fetch a group."""
    _encode(clips, card, 2, lookahead)
    f0 = encoder.fetches
    _, where = host_waits(lambda: _encode(clips, card, 2, lookahead), REPO)
    groups = -(-CLIPS // 2)
    assert encoder.fetches - f0 == groups
    assert sum(where.values()) == groups, where
    assert all(k.startswith("mp3tpu_torch/encoder.py:") and
               k.endswith(" event") for k in where), where


def _segment_results(dev, seed, G=512):
    """Segment-like results on `dev`: a side table, a compacted payload
    and n_nonfinite."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"side": torch.randint(-2000, 2000, (G, 19), dtype=torch.int16,
                                  device=dev, generator=g),
            "payload": torch.randint(-2**31, 2**31 - 1, (G * 40,),
                                     dtype=torch.int32, device=dev,
                                     generator=g),
            "n_nonfinite": torch.tensor(seed, device=dev)}


@pytest.mark.cuda
def test_download_is_pinned_and_its_source_recorded(card, monkeypatch):
    """The copy lands in pinned host memory; the flat source is marked
    as in use on the copy stream; the values read back are the tensors'."""
    L3 = encoder._Layer3Framing(EncoderConfig(sample_rate_hz=RATE,
                                              **CORPUS_CFG), card)
    hs = [_segment_results(card, s) for s in (1, 2)]
    recorded = []
    real = torch.Tensor.record_stream

    def record(self, stream):
        recorded.append((self.device, self.dtype, self.numel(), stream))
        return real(self, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", record)
    d = L3.fetch_async(hs)
    n = sum(h[k].numel() for h in hs for k in h)
    assert d.host.is_pinned() and d.host.device.type == "cpu"
    dev = hs[0]["side"].device
    assert recorded == [(dev, torch.int32, n, encoder.copy_stream(dev))]
    got = d.wait()
    for h, g in zip(hs, got):
        np.testing.assert_array_equal(g["side"], h["side"].cpu().numpy())
        np.testing.assert_array_equal(
            g["payload"], h["payload"].cpu().numpy().view(np.uint32))
        assert g["n_nonfinite"] == int(h["n_nonfinite"])


@pytest.mark.cuda
def test_an_earlier_download_still_copying_raises(card):
    """A download passed as `earlier` whose copy has not run yet (it
    queues behind a second of sleep on the caller's stream) is refused,
    not read.  Both segments' tensors are made before the sleep: making
    one from host data waits for the stream."""
    L3 = encoder._Layer3Framing(EncoderConfig(sample_rate_hz=RATE,
                                              **CORPUS_CFG), card)
    hs = [_segment_results(card, s) for s in (1, 2)]
    first = L3.fetch_async(hs[:1])
    torch.cuda._sleep(2_000_000_000)
    late = L3.fetch_async(hs[1:])
    try:
        with pytest.raises(RuntimeError, match="before its copy"):
            first.wait(earlier=[late])
    finally:
        torch.cuda.synchronize()
    assert late.wait()[0]["n_nonfinite"] == 2
