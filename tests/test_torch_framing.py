"""How a Layer III clip's PCM reaches the segments' pinned buffers.

``_Layer3Framing.frame`` returns int16 input as a view of the caller's
samples, unpadded, and takes every other dtype through the float32
sanitizing path (counted in ``encoder.float_frames``);
``fill_granules`` copies a clip's granules into a segment's blocks and
its 4-granule halo, zeros past the clip's last sample.  Here the buffers
that ``encode_layer3_fast`` and ``dispatch_group`` fill are held to the
earlier design -- every clip through float32, ``nan_to_num``, the clip,
the pad to whole frames, then the padded array sliced into each
segment (``_frame_padded`` below) -- over layouts, strides and lengths
around the frame and segment edges; and int16 input gives the bytes of
the same samples passed as float32.
"""
import collections
import sys
import threading

import numpy as np
import pytest
import torch

from mp3tpu.tables import mpeg
from mp3tpu_torch import encoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.encoder import (_Layer3Framing, _plan_segments,
                                  encode_layer3_fast, fill_granules)
from mp3tpu_torch.parallel import corpus

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

MONO = dict(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64)
STEREO = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)
#: the largest super-chunk bucket, in samples of one channel
SUPER = encoder.SUPER_BUCKETS[-1] * 576
#: clip lengths at the frame and segment edges: one sample, one short of
#: a granule, one frame, one past it, a whole super-chunk, and one past
#: the plan's first segment boundary
LENGTHS = [1, 575, 1152, 1153, SUPER, SUPER + 1]
#: (n, nch) and (nch, n) stereo, 1-d mono
LAYOUTS = ["nch_n", "n_nch", "mono_1d"]

_FRAMINGS = {}


def _framing(kw):
    key = kw["mode"]
    if key not in _FRAMINGS:
        _FRAMINGS[key] = _Layer3Framing(EncoderConfig(sample_rate_hz=44100,
                                                      **kw), "cpu")
    return _FRAMINGS[key]


def _frame_padded(L3, pcm):
    """The earlier ``frame``: (nch, nframes * spf) int16, zero-padded to
    whole frames, every input through float32."""
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    if pcm.shape[0] != L3.nch:
        raise ValueError(f"pcm has {pcm.shape[0]} channels, config {L3.nch}")
    nframes = -(-pcm.shape[1] // L3.spf)
    pcm = np.pad(pcm, ((0, 0), (0, nframes * L3.spf - pcm.shape[1])))
    pcm = np.clip(np.nan_to_num(pcm, nan=0.0, posinf=32767.0,
                                neginf=-32768.0), -32768, 32767)
    return pcm.astype(np.int16), nframes


def _segment_buffers(L3, clips):
    """Each segment's (B*nch, 4 + n_pad, 576) blocks, halo included, of a
    group of clips, as the earlier design stacked them: every clip framed
    and padded, stacked as lanes of a zeroed (L, G_max, 576) array, and
    each segment sliced out of it."""
    nch, mode_gr = L3.nch, L3.mode_gr
    framed = [_frame_padded(L3, p) for p in clips]
    G_max = max(nf for _, nf in framed) * mode_gr
    blocks = np.zeros((len(clips) * nch, G_max, 576), np.int16)
    for b, (pcm, nf) in enumerate(framed):
        blocks[b * nch:(b + 1) * nch, :nf * mode_gr] = \
            pcm.reshape(nch, nf * mode_gr, 576)
    out = []
    for pos, n_real, n_pad in _plan_segments(G_max):
        bl = np.zeros((len(clips) * nch, 4 + n_pad, 576), np.int16)
        if pos:
            bl[:, :4] = blocks[:, pos - 4:pos]
        bl[:, 4:4 + n_real] = blocks[:, pos:pos + n_real]
        out.append(bl)
    return out


def _clip(layout, n, seed, contiguous=True, dtype=np.int16):
    """A clip of n samples a channel in `layout`, cut from a longer array
    (a non-contiguous slice unless `contiguous`), full-scale noise."""
    rng = np.random.RandomState(seed)
    pad = 0 if contiguous else 3
    if layout == "mono_1d":
        step = 1 if contiguous else 2
        x = rng.randint(-32768, 32768, (n + pad) * step).astype(dtype)
        return x[pad * step:][::step][:n]
    if layout == "nch_n":
        x = rng.randint(-32768, 32768, (2, n + pad)).astype(dtype)
        return x[:, pad:]
    x = rng.randint(-32768, 32768, (n + pad, 2 + 2 * pad)).astype(dtype)
    return x[pad:, pad:pad + 2]


def _cfg(layout):
    return MONO if layout == "mono_1d" else STEREO


class _Stop(Exception):
    pass


def _one_shot_buffers(monkeypatch, kw, pcm):
    """The blocks of every segment that ``encode_layer3_fast`` uploads for
    `pcm`, read at ``_Layer3Framing.segment``; the encode stops before its
    first wait."""
    got = []

    class Pending:
        def wait(self, earlier=()):
            raise _Stop

    def segment(self, blocks_h4, fsm, size, *args):
        got.append(blocks_h4.numpy().copy())
        return {"fsm_state": fsm, "size": size}

    monkeypatch.setattr(_Layer3Framing, "segment", segment)
    monkeypatch.setattr(_Layer3Framing, "fetch_async",
                        lambda self, hs, keys=None: Pending())
    with pytest.raises(_Stop):
        encode_layer3_fast(pcm, EncoderConfig(sample_rate_hz=44100, **kw),
                           "cpu")
    return got


def _group_buffers(monkeypatch, kw, clips):
    """The blocks of every segment that ``dispatch_group`` uploads for a
    group of `clips`, read at ``upload``; the device chain is stubbed."""
    L3 = _Layer3Framing(EncoderConfig(sample_rate_hz=44100, **kw), "cpu")
    got = []

    class Enc:
        def analyze_demand_fused(self, x, fsm):
            return collections.defaultdict(lambda: None, fsm_state=fsm)

        def encode_final(self, *args, **kwargs):
            return {}

    def record(host, dev):
        got.append(host.numpy().copy())
        return host

    L3.enc = Enc()
    L3.fetch_async = lambda hs: None
    monkeypatch.setattr(corpus, "upload", record)
    monkeypatch.setattr(
        corpus, "_plan_budgets_corpus",
        lambda pes, p23s, plan, *a: ([None] * len(plan), None, None))
    corpus.dispatch_group(L3, [L3.frame(p) for p in clips], 0, 0)
    return got


def _assert_buffers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_shot_buffers_equal_the_padded_frames(monkeypatch, layout, n,
                                                  contiguous):
    """Every segment's pinned blocks, halos included, equal the earlier
    design's for int16 input, and ``frame`` copies nothing; a stereo clip
    of one sample is refused by both (either orientation reads it as one
    channel of two samples)."""
    kw = _cfg(layout)
    L3 = _framing(kw)
    pcm = _clip(layout, n, n, contiguous)
    if not contiguous and n > 1:
        assert not pcm.flags.c_contiguous
    if n == 1 and layout != "mono_1d":
        with pytest.raises(ValueError, match="1 channels, config 2"):
            _frame_padded(L3, pcm)
        with pytest.raises(ValueError, match="1 channels, config 2"):
            L3.frame(pcm)
        return
    want = _segment_buffers(L3, [pcm])
    f0 = encoder.float_frames
    framed, nframes = L3.frame(pcm)
    assert encoder.float_frames == f0
    assert framed.dtype == np.int16 and framed.shape == (L3.nch, n)
    assert np.shares_memory(framed, pcm)
    assert nframes == _frame_padded(L3, pcm)[1]
    _assert_buffers_equal(_one_shot_buffers(monkeypatch, kw, pcm), want)
    if n == SUPER + 1:
        assert len(want) == 2 and want[1][:, :4].any()


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "strided"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_group_buffers_equal_the_stacked_lanes(monkeypatch, layout,
                                               contiguous):
    """``dispatch_group`` fills each clip's lanes of every segment's
    pinned buffer straight from the clip: equal to the earlier zeroed
    lane stack, for clips of unequal lengths over a ramp, a full and a
    padded segment: the shorter ones end inside the first segment, or
    inside the second before the last one's halo."""
    kw = _cfg(layout)
    L3 = _framing(kw)
    clips = [_clip(layout, n, s, contiguous)
             for s, n in enumerate((1153, SUPER + 1, 575, 2 * SUPER))]
    want = _segment_buffers(L3, clips)
    assert len(want) == 3
    _assert_buffers_equal(_group_buffers(monkeypatch, kw, clips), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_other_dtypes_are_sanitized_as_before(monkeypatch, layout, dtype):
    """Input that is not int16 takes the float path: NaN -> 0, +/-Inf ->
    full scale, out-of-range values clipped, fractions truncated, as the
    earlier ``frame``; one count of ``float_frames`` a clip."""
    kw = _cfg(layout)
    L3 = _framing(kw)
    n = SUPER + 1
    pcm = _clip(layout, n, 5, contiguous=False, dtype=np.float64) * 1.7
    pcm += 0.4
    flat = pcm.reshape(-1) if layout == "mono_1d" else pcm[:, 0] \
        if layout == "n_nch" else pcm[0]
    if np.issubdtype(dtype, np.floating):
        flat[:4] = [np.nan, np.inf, -np.inf, 1e9]
    pcm = pcm.astype(dtype)
    want = _segment_buffers(L3, [pcm])
    padded, nframes = _frame_padded(L3, pcm)
    f0 = encoder.float_frames
    framed, nf = L3.frame(pcm)
    assert encoder.float_frames == f0 + 1
    assert nf == nframes and framed.dtype == np.int16
    np.testing.assert_array_equal(framed, padded[:, :n])
    if np.issubdtype(dtype, np.floating):
        np.testing.assert_array_equal(framed[0, :4],
                                      [0, 32767, -32768, 32767])
    f0 = encoder.float_frames
    _assert_buffers_equal(_one_shot_buffers(monkeypatch, kw, pcm), want)
    assert encoder.float_frames == f0 + 1


@pytest.mark.parametrize("n, g0, ng", [(1, 0, 4), (575, 0, 2), (576, 0, 1),
                                       (1153, 1, 3), (1153, 2, 4),
                                       (1153, 8, 4), (5000, 4, 4),
                                       (1153, -4, 7), (1153, -4, 4),
                                       (1153, -6, 2), (575, -1, 3)])
def test_fill_granules_zeros_outside_the_clip(n, g0, ng):
    """``fill_granules`` overwrites its whole destination: the clip's
    granules [g0, g0 + ng), zeros before its first sample and past its
    last (a destination full of other values is cleared)."""
    pcm = np.arange(1, 2 * n + 1, dtype=np.int16).reshape(2, n)
    dst = np.full((2, ng, 576), -7, np.int16)
    fill_granules(dst, pcm, g0)
    lead = max(-g0, 0)
    want = np.zeros((2, (lead + max(g0 + ng, 0)) * 576 + n), np.int16)
    want[:, lead * 576:lead * 576 + n] = pcm
    a = (lead + g0) * 576
    np.testing.assert_array_equal(dst, want[:, a:a + ng * 576]
                                  .reshape(2, ng, 576))


def test_float_frames_counts_every_clip_framed_from_threads():
    """``float_frames`` loses no count when threads frame float clips at
    once (``encode_corpus`` frames from a thread pool), with the
    interpreter switching threads as often as it can."""
    L3 = _framing(STEREO)
    pcm = np.zeros((2, 1153), np.float32)
    f0, n_threads, each = encoder.float_frames, 8, 200

    def work():
        for _ in range(each):
            L3.frame(pcm)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert encoder.float_frames - f0 == n_threads * each


def _signal(nch, secs, seed):
    """Tones and noise, (nch, n) int16."""
    rng = np.random.RandomState(seed)
    n = int(secs * 44100)
    t = np.arange(n) / 44100.0
    x = np.stack([0.3 * np.sin(2 * np.pi * (300 + 90 * c + 40 * seed) * t)
                  + 0.03 * rng.randn(n) for c in range(nch)])
    return np.clip(x * 22000, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_shot_bytes_equal_the_float_path(layout):
    """``encode_layer3_fast`` on an int16 clip (a strided slice in each
    layout) gives the bytes of the same samples passed as float32, which
    take the sanitizing path."""
    kw = _cfg(layout)
    nch = 1 if layout == "mono_1d" else 2
    x = _signal(nch, 0.7, 4)
    pcm = {"nch_n": x, "n_nch": x.T, "mono_1d": x[0]}[layout]
    cfg = EncoderConfig(sample_rate_hz=44100, **kw)
    f0 = encoder.float_frames
    got = encode_layer3_fast(pcm, cfg, "cpu")
    assert encoder.float_frames == f0
    want = encode_layer3_fast(pcm.astype(np.float32), cfg, "cpu")
    assert encoder.float_frames == f0 + 1
    assert len(got) > 0 and got == want


def test_corpus_bytes_equal_the_float_path():
    """``encode_corpus_batched`` at batch 2 over stereo clips of unequal
    lengths gives the same bytes for int16 clips as for the same samples
    passed as float32."""
    xs = [_signal(2, 0.6, 1), _signal(2, 1.0, 2)[:, 7:]]
    f0 = encoder.float_frames
    got, _ = corpus.encode_corpus_batched([(x, 44100) for x in xs], STEREO,
                                          "cpu", batch=2)
    assert encoder.float_frames == f0
    want, _ = corpus.encode_corpus_batched(
        [(x.astype(np.float32), 44100) for x in xs], STEREO, "cpu", batch=2)
    assert encoder.float_frames == f0 + 2
    assert [len(g) for g in got] == [len(w) for w in want]
    assert got == want
