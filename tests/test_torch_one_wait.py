"""One host wait per encode, checked on the CPU (``encoder.py``,
``parallel/corpus.py``).

On the card the Layer III encode functions queue the whole segment chain -- the
analysis and demand loop, the reservoir scan (K4), the final loop and
emission -- and its downloads, and then wait once, at ``Download.wait``,
as the JAX package's one program chain does
(``mp3tpu/encoder.py:206-225``).  The host cannot time a CPU run's
waits, so these tests record the calls in order: ``encode_layer3_fast``
queues every segment, carrying the automaton state and the reservoir
level as tensors from one segment's outputs to the next's inputs, and
each segment's download behind it (``fetch_async``, as the JAX package's
per-segment ``device_get``), before its one wait; ``dispatch_group``
queues every analysis, the batched scan, every final encode and the
group's download before the group's one wait; ``StreamEncoder`` fetches
once a window; and the block uploads go through ``pinned`` buffers.
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch import encoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import resv
from mp3tpu_torch.parallel import corpus
from mp3tpu_torch.runtime import profiling
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools.signals import make_signal

torch.set_num_threads(1)


def _cfg(rate=44100):
    return EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                         sample_rate_hz=rate)


@pytest.fixture
def calls(monkeypatch):
    """A log of the encode functions' calls, in order: ("segment", the carry's
    types), ("analysis",), ("scan",), ("final",), ("queue", segments of a
    queued download) and ("wait", segments read by the wait)."""
    log = []

    def wrap(owner, name, entry):
        real = getattr(owner, name)

        def logged(*args, **kwargs):
            log.append(entry(*args, **kwargs))
            return real(*args, **kwargs)
        monkeypatch.setattr(owner, name, logged)

    wrap(encoder._Layer3Framing, "segment",
         lambda self, blocks, fsm, size, *a: ("segment", type(fsm),
                                              type(size)))
    wrap(encoder._Layer3Framing, "fetch_async",
         lambda self, hs, keys=None: ("queue", len(hs)))
    wrap(encoder.Download, "wait",
         lambda self, earlier=(): ("wait", sum(len(d.layout) for d in
                                               (*earlier, self))))
    wrap(Layer3SegmentEncoder, "analyze_demand_fused",
         lambda *a, **k: ("analysis",))
    wrap(Layer3SegmentEncoder, "encode_final", lambda *a, **k: ("final",))
    wrap(resv, "scan_budgets_batched", lambda *a, **k: ("scan",))
    return log


def _top_level(calls):
    """The calls of the one-shot and stream encoders themselves (each
    segment call makes its analysis and final encode)."""
    return [c for c in calls if c[0] in ("segment", "queue", "wait")]


def test_one_shot_fetches_once_after_every_segment(calls):
    """Three segments at chunk 64, the carry passed on as tensors: each
    segment's download is queued right behind it, and the only wait comes
    after the last segment is queued, and reads all three."""
    prof = profiling.Profiler()
    f0, r0 = encoder.fetches, encoder.retry_fetches
    out = encoder.encode_layer3_fast(make_signal(2.0, 44100), _cfg(), "cpu",
                                     chunk=64, prof=prof)
    assert len(out) > 0 and prof.meta["guard_retries"] == 0
    assert encoder.retry_fetches == r0
    segments = [c for c in calls if c[0] == "segment"]
    assert len(segments) == prof.meta["segments"] == 3
    assert _top_level(calls) == [c for seg in segments
                                 for c in (seg, ("queue", 1))] + [("wait", 3)]
    assert encoder.fetches - f0 == 1
    # the first segment starts from a fresh level, the others from the
    # tensors the segment before returned
    assert all(c[1:] == (torch.Tensor, torch.Tensor) for c in segments[1:])


def test_corpus_group_fetches_once_after_its_final_encodes(calls,
                                                           monkeypatch):
    """A group of two clips of unequal length in segments of 64 granules:
    every analysis, then the one batched scan, then every final encode,
    then the group's one download queued and waited for."""
    monkeypatch.setattr(corpus, "_plan_segments",
                        lambda G: encoder._plan_segments(G, (64,)))
    clips = [(make_signal(2.0, 44100), 44100),
             (make_signal(1.0, 44100)[:30000], 44100)]
    outs, _ = corpus.encode_corpus_batched(
        clips, dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128),
        "cpu", batch=2)
    assert len(outs) == 2 and all(len(o) > 0 for o in outs)
    n = sum(1 for c in calls if c[0] == "analysis")
    assert n == 3
    assert calls == [("analysis",)] * n + [("scan",)] + [("final",)] * n \
        + [("queue", n), ("wait", n)]


def test_stream_fetches_once_a_window(calls):
    """Windows of 64 granules: one fetch per window (a download queued
    and waited for), each after its segment; the scan's level is carried
    as a tensor and a checkpoint reads it as an int."""
    pcm = make_signal(1.5, 44100)
    enc = encoder.StreamEncoder(_cfg(), "cpu", window=64)
    out = enc.feed(pcm[:44100])
    windows = [c for c in calls if c[0] == "segment"]
    assert len(windows) == 44100 // (64 * 576) and len(out) > 0
    assert _top_level(calls) == [c for w in windows
                                 for c in (w, ("queue", 1), ("wait", 1))]
    assert isinstance(enc.scan_size, torch.Tensor)
    ckpt = enc.checkpoint()
    assert isinstance(ckpt["scan_size"], int)
    assert ckpt["scan_size"] == int(enc.scan_size)


def test_uploads_on_the_cpu_are_the_buffers():
    """On the CPU a buffer is a plain zeroed tensor of the asked dtype and
    ``upload`` hands it on as it is."""
    for dtype in (torch.int16, torch.float32):
        host = encoder.pinned((2, 8, 576), dtype, torch.device("cpu"))
        assert host.dtype == dtype and not host.is_pinned()
        assert not host.any()
        host.numpy()[0, 0, 0] = 7
        assert encoder.upload(host, torch.device("cpu")) is host
        assert np.asarray(host)[0, 0, 0] == 7


def test_settle_reads_the_scan_once_and_fetches_each_reencode(monkeypatch):
    """A guard retry forced on one segment of a 1 s encode: after the
    segments' own downloads (one queued a segment), ``settle`` reads
    every segment's target and demand in one fetch and each re-encode's
    results in one more, both counted in ``retry_fetches``; the bytes
    stay a valid stream of the same length."""
    pcm, cfg = make_signal(1.0, 44100), _cfg()
    want = encoder.encode_layer3_fast(pcm, cfg, "cpu", chunk=64)
    real, calls = encoder.resv_guard, []

    def guard(p23, nframes, nch, mean_bits, resv_max, mode_gr, size=None):
        res = real(p23, nframes, nch, mean_bits, resv_max, mode_gr,
                   size=size)
        calls.append(res[0])
        if len(calls) == 1:      # flag an overdraw once, with no limits cut
            return (True,) + tuple(res[1:])
        return res

    monkeypatch.setattr(encoder, "resv_guard", guard)
    seen = []
    real_fetch = encoder._Layer3Framing.fetch_async
    monkeypatch.setattr(encoder._Layer3Framing, "fetch_async",
                        lambda self, hs, keys=None: seen.append(
                            (len(hs), keys)) or real_fetch(self, hs, keys))
    f0, r0 = encoder.fetches, encoder.retry_fetches
    prof = profiling.Profiler()
    out = encoder.encode_layer3_fast(pcm, cfg, "cpu", chunk=64, prof=prof)
    assert prof.meta["guard_retries"] == 1
    n = prof.meta["segments"]
    assert seen == [(1, None)] * n + [(n, ("target", "demand")),
                                      (n, ("side", "payload"))]
    assert (encoder.fetches - f0, encoder.retry_fetches - r0) == (3, 2)
    assert len(out) == len(want)
