"""The corpus's group lookahead (``encode_corpus_batched(lookahead=)``,
``dispatch_group`` / ``collect_group`` in ``parallel/corpus.py``) on the
CPU: the port's counterpart of the JAX package's loop at
``mp3tpu/parallel/corpus.py:305-316``, which keeps up to
``MP3TPU_CORPUS_LOOKAHEAD`` groups in flight before it collects the
oldest.

On the CPU every copy is made at once, so these tests hold what the
lookahead must not change -- the bytes of every clip, in corpus order,
a forced guard retry included, and the stats -- and the order of the
calls, against a plain model of the JAX package's loop.  That a pinned
buffer is not read before its copy has run shows only on the card
(``tests/test_torch_corpus_pipeline_card.py``, ``chip_smoke.py`` phase
10).
"""
import numpy as np
import pytest
import torch

from mp3tpu.parallel import corpus as jcorpus
from mp3tpu.tables import mpeg
from mp3tpu_torch import encoder
from mp3tpu_torch.decoder import decode_mp3
from mp3tpu_torch.decoder.layer3 import snr_db
from mp3tpu_torch.parallel import corpus
from test_torch_one_wait import calls  # noqa: F401  (the fixture)

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

MONO = dict(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64)
STEREO = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)


def _mono_clips():
    """Five mono clips of 0.3 to 1.8 s, each its own tone."""
    rng = np.random.RandomState(3)
    clips = []
    for s, secs in enumerate((0.3, 0.8, 1.2, 1.8, 0.5)):
        n = int(secs * 44100)
        t = np.arange(n) / 44100.0
        x = 0.3 * np.sin(2 * np.pi * (300 + 70 * s) * t) \
            + 0.03 * rng.randn(n)
        clips.append((np.clip(x[None, :] * 22000, -32768, 32767)
                      .astype(np.int16), 44100))
    return clips


def _stereo_clips():
    """tests/test_torch_corpus.py's stereo clips of 0.6 and 1.0 s: the
    shorter one's tail granules past its length are not silent."""
    rng = np.random.RandomState(11)
    clips = []
    for s, secs in enumerate((0.6, 1.0)):
        n = int(secs * 44100)
        t = np.arange(n) / 44100.0
        left = 0.3 * np.sin(2 * np.pi * (350 + 60 * s) * t) \
            + 0.03 * rng.randn(n)
        right = 0.25 * np.sin(2 * np.pi * (500 + 80 * s) * t) \
            + 0.03 * rng.randn(n)
        clips.append((np.clip(np.stack([left, right]) * 22000,
                              -32768, 32767).astype(np.int16), 44100))
    return clips


CASES = {"mono5": (_mono_clips, MONO), "stereo2": (_stereo_clips, STEREO)}
#: the lookahead-0 run of each case, made once a test process
_IN_ORDER = {}


def _in_order(case):
    if case not in _IN_ORDER:
        clips, kw = CASES[case][0](), CASES[case][1]
        _IN_ORDER[case] = corpus.encode_corpus_batched(
            clips, kw, "cpu", batch=1, lookahead=0)
    return _IN_ORDER[case]


@pytest.mark.parametrize("lookahead", [0, 1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_lookahead_gives_the_in_order_bytes(case, lookahead):
    """Lane batch 1 (a group a clip): every clip's stream at `lookahead`
    equals the in-order form's, in corpus order, with the same stats but
    the wall."""
    make, kw = CASES[case]
    clips = make()
    want, want_stats = _in_order(case)
    outs, stats = corpus.encode_corpus_batched(clips, kw, "cpu", batch=1,
                                               lookahead=lookahead)
    assert outs == want
    assert all(o[0] == 0xFF and (o[1] & 0xF0) == 0xF0 for o in outs)
    assert stats.keys() == want_stats.keys()
    assert (stats["clips"], stats["audio_s"]) == \
        (want_stats["clips"], want_stats["audio_s"]) == \
        (len(clips), pytest.approx(sum(p.shape[1] / r for p, r in clips)))
    assert stats["wall_s"] > 0 and stats["x_realtime"] > 0


def _jax_loop(segments, lookahead):
    """The JAX package's loop (``mp3tpu/parallel/corpus.py:308-314``) as
    the calls the port makes: each group dispatched -- its analyses, the
    scan, its final encodes, its download queued -- then the oldest group
    collected (its wait) while more than `lookahead` are pending, and the
    rest collected in order at the end.  segments: each group's segment
    count."""
    log, pending = [], []
    for n in segments:
        log += [("analysis",)] * n + [("scan",)] + [("final",)] * n \
            + [("queue", n)]
        pending.append(n)
        if len(pending) > lookahead:
            log.append(("wait", pending.pop(0)))
    return log + [("wait", n) for n in pending]


@pytest.mark.parametrize("lookahead", [0, 1, 2, 8])
def test_call_order_is_the_jax_loops(calls, monkeypatch, lookahead):
    """Five groups of 1, 1, 2, 3 and 1 segments of 64 granules: group k's wait
    comes after group k + lookahead's final encodes and queued download,
    and before group k + lookahead + 1's first analysis."""
    monkeypatch.setattr(corpus, "_plan_segments",
                        lambda G: encoder._plan_segments(G, (64,)))
    clips = _mono_clips()
    outs, _ = corpus.encode_corpus_batched(clips, MONO, "cpu", batch=1,
                                           lookahead=lookahead)
    assert len(outs) == len(clips)
    segments = [len(encoder._plan_segments(
        2 * -(-p.shape[1] // 1152), (64,))) for p, _ in clips]
    assert segments == [1, 1, 2, 3, 1]
    assert calls == _jax_loop(segments, lookahead)
    # read off the log itself: where each group's download is queued,
    # where its first analysis is, and where each wait is
    queued = [i for i, c in enumerate(calls) if c[0] == "queue"]
    waits = [i for i, c in enumerate(calls) if c[0] == "wait"]
    starts = [0] + [calls.index(("analysis",), q) for q in queued[:-1]]
    assert len(queued) == len(waits) == len(clips)
    for k, w in enumerate(waits):
        assert w > queued[min(k + lookahead, len(clips) - 1)]
        if k + lookahead + 1 < len(clips):
            assert w < starts[k + lookahead + 1]


def _forced_retry(monkeypatch):
    """Flag an overdraw on the first guard call (no limits cut), as
    tests/test_torch_one_wait.py's settle test does."""
    real, seen = encoder.resv_guard, []

    def guard(p23, nframes, nch, mean_bits, resv_max, mode_gr, size=None):
        res = real(p23, nframes, nch, mean_bits, resv_max, mode_gr,
                   size=size)
        seen.append(res[0])
        if len(seen) == 1:
            return (True,) + tuple(res[1:])
        return res

    monkeypatch.setattr(encoder, "resv_guard", guard)
    return seen


def test_a_retry_in_a_pipelined_group_gives_the_in_order_bytes(monkeypatch):
    """A guard retry forced on group 0's clip of a lookahead-3 run: its
    re-encode queues behind the groups in flight, and the corpus's bytes
    and fetches equal the lookahead-0 run's under the same forced retry."""
    clips = _stereo_clips()
    got = {}
    for lookahead in (0, 3):
        with monkeypatch.context() as m:
            seen = _forced_retry(m)
            f0, r0 = encoder.fetches, encoder.retry_fetches
            outs, _ = corpus.encode_corpus_batched(
                clips, STEREO, "cpu", batch=1, lookahead=lookahead)
            got[lookahead] = (outs, encoder.fetches - f0,
                              encoder.retry_fetches - r0)
            # the forced call, its retry's, and the other clip's
            assert len(seen) == len(clips) + 1
    assert got[3] == got[0]
    outs, fetches, retries = got[3]
    # one wait a group, and settle's two retry fetches (the scan's
    # target and demand, then the re-encode)
    assert (fetches, retries) == (len(clips) + 2, 2)
    assert [len(o) for o in outs] == [len(o) for o in _in_order(
        "stereo2")[0]]


def _snrs(pcm, out):
    dec, _ = decode_mp3(out)
    return [float(snr_db(pcm[c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[0])]


@pytest.mark.parametrize("lookahead", [0, 3])
def test_matches_jax_at_the_same_lookahead(monkeypatch, lookahead):
    """The port at `lookahead` against the JAX package's
    ``encode_corpus_batched`` with ``MP3TPU_CORPUS_LOOKAHEAD`` =
    `lookahead`, on the two stereo clips at lane batch 1: equal lengths,
    each channel's decoded SNR within 0.5 dB (float32 batch-shape
    round-off may move single quantized lines)."""
    monkeypatch.setenv("MP3TPU_CORPUS_LOOKAHEAD", str(lookahead))
    clips = _stereo_clips()
    outs, _ = corpus.encode_corpus_batched(clips, STEREO, "cpu", batch=1,
                                           lookahead=lookahead)
    jouts, _ = jcorpus.encode_corpus_batched(clips, STEREO, batch=1)
    assert len(outs) == len(jouts) == len(clips)
    for (pcm, _), out, jout in zip(clips, outs, jouts):
        assert len(out) == len(jout)
        for s_t, s_j in zip(_snrs(pcm, out), _snrs(pcm, jout)):
            assert abs(s_t - s_j) < 0.5, (s_t, s_j)
            assert s_t > 10.0, s_t


@pytest.mark.parametrize("lookahead", [-1, 1.5, "3", True])
def test_lookahead_must_be_an_integer_at_least_0(lookahead):
    with pytest.raises(ValueError, match="lookahead"):
        corpus.encode_corpus_batched(_mono_clips()[:1], MONO, "cpu",
                                     lookahead=lookahead)


def test_host_waits_counts_each_synchronization_once(monkeypatch):
    """``tools.host_waits`` with torch's reports made by hand (a CPU torch
    makes none): a blocking copy reports a stream synchronization to the
    GPU trace and, when it returns, a warning of the sync debug mode, from
    one line -- one wait; an event synchronization (the trace alone) and
    an operation that only the debug mode reports -- one each; two device
    synchronizations on one line -- two; nothing outside the call."""
    import warnings

    from torch.cuda import _gpu_trace as trace

    from mp3tpu_torch.tools import host_waits
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)

    msg = "called a synchronizing CUDA operation"
    stream = trace.StreamSynchronizationCallbacks.fire_callbacks
    device = trace.DeviceSynchronizationCallbacks.fire_callbacks

    def waits():
        stream(1); warnings.warn(msg)  # noqa: E702
        trace.EventSynchronizationCallbacks.fire_callbacks(2)
        warnings.warn(msg)
        device(); device()  # noqa: E702
        return 7

    out, where = host_waits(waits)
    assert out == 7
    here = __file__.rsplit("/", 1)[-1]
    assert all(k.split(":")[0].endswith(here) for k in where), where
    assert sorted((k.split()[-1], n) for k, n in where.items()) == [
        ("device", 2), ("event", 1), ("stream", 1), ("warned", 1)], where
    trace.EventSynchronizationCallbacks.fire_callbacks(3)
    assert host_waits(lambda: 8) == (8, {})
