"""The Layer I/II analysis as a CUDA graph, checked on the CPU
(``ops/layer12.py``, ``ops/graphs.py``, ``encoder._layer12_frame``).

``_analyze_frames`` is the analysis of a whole clip (filterbank, psy
model 2, scale factors, scfsi, the joint combination) on (nch, F * spf)
int16 or float32 PCM; on a CUDA tensor ``analyze_frames`` replays it as
one graph a key (the PCM's dtype and frame count, layer, sblimit, nch,
rate and tables), as the JAX package jits ``jaxlayer12.analyze_frames``
with the frame count static.  These tests check that it can be captured
(an aten-op log on "cpu" and "meta": no host read, no tensor from host
data, no op across devices); run the captured host side
(``graphs.run``) with a stand-in capture against the op-by-op form
(``analyze_frames_eager``) call after call, its outputs never in a
replay's pool; check what changes the key; hold int16 framing to the
float32 path's outputs and bytes, and a float PCM to float32; hold the
one copy into the upload buffer to the zeroed array it replaced, with
garbage left in the buffer before framing never reaching the bytes;
and hold the int16 analysis to the JAX function fed the same values as
float32, within tests/test_torch_layer12.py's tolerances.

With psy model 2 the back half (the SMR, K5, the quantizers,
``marshal_frames``, K6) is a second graph of the analysis' entry
(``layer12.encode_frames``, ``encoder._layer12_replayed``).  Its torch
part is held capturable the same way (K5's outputs given as inputs);
the replayed route's host side, with stand-in captures, gives the
op-by-op route's values, lengths and bytes call after call; the key
carries every value the back half bakes in; and the copy of K6's buffer
that a call returns outlives the next call of its key.  The graphs
themselves are checked on the card (tests/test_torch_layer12_card.py,
chip_smoke.py phase 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.ops import jaxlayer12 as J
from mp3tpu_torch import encoder as E
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.ops import alloc12 as A12
from mp3tpu_torch.ops import graphs
from mp3tpu_torch.ops import layer12 as L12
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools import yardstick_form
from test_torch_analysis_graph import (_assert_equal, pooled_stand_in,
                                       shares_storage)
from test_torch_graph import HOST_DATA, HOST_READS, OpLog

torch.set_num_threads(1)

#: (layer, nch, sblimit, rate, frames) of the cases
CASES = {"l1_stereo": (1, 2, 32, 44100, 7), "l2_stereo": (2, 2, 30, 44100, 4),
         "l2_mono": (2, 1, 27, 48000, 5), "l1_mono_32k": (1, 1, 32, 32000, 6)}


def pcm_of(layer, nch, frames, seed=0):
    """(nch, frames * spf) int16: noise, a tone and a click, so that every
    scale factor class and scfsi pattern takes part."""
    spf = 384 if layer == 1 else 1152
    n = frames * spf
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 44100.0
    x = rng.randn(nch, n) * rng.choice([30.0, 600.0, 6000.0], (nch, 1))
    x += 9000 * np.sin(2 * np.pi * (700 + 300 * np.arange(nch))[:, None] * t)
    x[:, n // 3:n // 3 + 64] += 20000
    return torch.tensor(np.clip(x, -32768, 32767).astype(np.int16))


def analyze(pcm, case, form=L12.analyze_frames_eager):
    layer, nch, sblimit, rate, _ = CASES[case]
    return form(pcm, layer, sblimit, nch, float(rate))


@pytest.fixture
def l12_graphs(monkeypatch):
    """An empty Layer I/II analysis cache of its own, zeroed counts."""
    cache = graphs.GraphCache(4)
    monkeypatch.setattr(L12, "GRAPHS", cache)
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    return cache


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["l1_stereo", "l2_stereo", "l2_mono"])
def test_analysis_is_capture_safe(case, device, dtype):
    """The analysis under an aten-op log, its tables made first (as the
    warm-up makes them): no host read of a device value, no tensor from
    host data, every tensor of every op on the run's device."""
    layer, nch, sblimit, rate, F = CASES[case]
    L12._tables(float(rate), torch.device(device))
    pcm = pcm_of(layer, nch, F).to(dtype).to(device)
    with OpLog() as log:
        out = L12._analyze_frames(pcm, layer, sblimit, nch, float(rate))
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 100
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device.type == device for t in out.values())
    assert ("scfsi" in out) == (layer == 2)
    assert ("j_sample" in out) == (nch == 2)


@pytest.mark.parametrize("case", CASES)
def test_int16_input_equals_float32(case):
    """The int16 PCM gives exactly the outputs of the same values as
    float32 (the conversion is the body's first op)."""
    layer, nch, _, _, F = CASES[case]
    pcm = pcm_of(layer, nch, F, seed=3)
    _assert_equal(analyze(pcm, case), analyze(pcm.to(torch.float32), case))


@pytest.mark.parametrize("case", ["l1_stereo", "l2_stereo", "l2_mono"])
def test_captured_analysis_equals_eager(l12_graphs, case):
    """``analyze_frames``' host side with a stand-in capture, three calls
    on one key (the warm-up and capture, then replays, the second on
    other PCM): each call's results equal ``analyze_frames_eager``'s
    exactly, are written by copy into tensors made outside the replays,
    and the first call's clones outlive the later replays."""
    layer, nch, sblimit, rate, F = CASES[case]
    pools = []
    record = pooled_stand_in(pools)
    calls = [pcm_of(layer, nch, F), pcm_of(layer, nch, F, seed=1),
             pcm_of(layer, nch, F)]
    kept = []
    for pcm in calls:
        entry, dropped = L12._run(dict(pcm=pcm), layer, sblimit, nch,
                                  float(rate), record)
        out = entry.outputs["l12_analysis"]
        _assert_equal(out, analyze(pcm, case))
        if pools:
            assert not [k for k, v in out.items()
                        if shares_storage(v, pools[-1])]
        kept.append({k: v.clone() for k, v in out.items()})
        assert dropped == []
    assert len(l12_graphs) == 1 and len(pools) == 2
    assert graphs.by_stage()["l12_analysis"] == (1, 2)
    _assert_equal(kept[0], kept[2])
    assert not torch.equal(kept[0]["sb"], kept[1]["sb"])


def test_a_full_cache_drops_its_oldest_key(l12_graphs):
    """Five frame counts through a cache of 4: the first key is dropped
    (the caller then synchronizes before letting it go) and captured
    again on its next call."""
    layer, nch, sblimit, rate, _ = CASES["l2_mono"]
    record = pooled_stand_in([])
    drops = []
    for F in (1, 2, 3, 4, 5, 1):
        _, dropped = L12._run(dict(pcm=pcm_of(layer, nch, F)), layer,
                              sblimit, nch, float(rate), record)
        drops.append(len(dropped))
    assert drops == [0, 0, 0, 0, 1, 1]
    assert graphs.by_stage()["l12_analysis"] == (6, 0)


def test_key_is_the_input_the_settings_and_the_tables():
    """The frame count, the dtype, layer, sblimit, nch and the rate's
    tables each change the key; equal calls share one."""
    def key(pcm, layer=2, sblimit=30, nch=2, rate=44100.0):
        return L12._key(dict(pcm=pcm), layer, sblimit, nch, rate)

    pcm = pcm_of(2, 2, 4)
    assert key(pcm) == key(pcm_of(2, 2, 4, seed=5))
    others = [key(pcm_of(2, 2, 5)), key(pcm.to(torch.float32)),
              key(pcm, layer=1), key(pcm, sblimit=27),
              key(pcm[:1], nch=1), key(pcm, rate=48000.0)]
    assert all(k != key(pcm) for k in others)
    assert len(set(others)) == len(others)
    # the rate's tables are other tensors, not only another value
    a, b = L12._tables(44100.0, "cpu"), L12._tables(48000.0, "cpu")
    assert a[0]["onehot_t"] is not b[0]["onehot_t"]
    assert a[2]["multiple"] is b[2]["multiple"]


def test_framing_keeps_int16_and_float():
    """``_layer12_frame``: int16 PCM stays int16, float PCM becomes float32
    (its fractions kept: never cast to int16), both transposed and padded
    to whole frames with zeros; the uploaded PCM has the framed dtype."""
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=44100)
    pcm = pcm_of(2, 2, 3).numpy().T[:3000]                 # (samples, ch)
    P, x = E._layer12_frame(pcm, cfg)
    assert x.dtype == np.int16 and x.shape == (2, 3 * 1152) and P.F == 3
    np.testing.assert_array_equal(x[:, :3000], pcm.T)
    assert not x[:, 3000:].any()
    P, xf = E._layer12_frame(pcm.astype(np.float64) + 0.25, cfg)
    assert xf.dtype == np.float32
    np.testing.assert_array_equal(xf[:, :3000], pcm.T + np.float32(0.25))
    for arr, want in ((x, torch.int16), (xf, torch.float32)):
        seen = []
        real = L12.analyze_frames
        try:
            L12.analyze_frames = lambda p, *a: seen.append(p.dtype) \
                or real(p, *a)
            E._layer12_analysis(arr, P, torch.device("cpu"))
        finally:
            L12.analyze_frames = real
        assert seen == [want]


@pytest.mark.parametrize("layer,mode,kbps", [(2, mpeg.MODE_STEREO, 192),
                                             (1, mpeg.MODE_JOINT, 384),
                                             (2, mpeg.MODE_MONO, 96)])
def test_int16_and_float32_pcm_give_the_same_bytes(layer, mode, kbps):
    """A Layer I/II encode of int16 PCM equals that of the same values as
    float32, byte for byte; the yardstick form too."""
    nch = 1 if mode == mpeg.MODE_MONO else 2
    pcm = pcm_of(layer, nch, 9, seed=7).numpy().T

    def encode(x):
        cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                            sample_rate_hz=44100)
        return E.encode_layer12_fast(x, cfg, "cpu")

    out = encode(pcm)
    assert out == encode(pcm.astype(np.float32))
    with yardstick_form():
        assert L12.analyze_frames is L12.analyze_frames_eager
        assert encode(pcm) == out
    assert L12.analyze_frames is not L12.analyze_frames_eager


def frame_as_before(pcm, spf):
    """The framing that ``_layer12_frame`` replaced, restated: float input
    cast to float32, transposed to (nch, n), then a zeroed array of whole
    frames with the clip copied in.  (frames, framed array)."""
    pcm = np.atleast_2d(np.asarray(pcm))
    if pcm.dtype != np.int16:
        pcm = pcm.astype(np.float32)
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    F = int(np.ceil(pcm.shape[1] / spf))
    framed = np.zeros((pcm.shape[0], F * spf), pcm.dtype)
    framed[:, :pcm.shape[1]] = pcm
    return F, framed


class GarbageTorch:
    """``torch`` for the encoder module, but every int16 or float32
    ``empty`` comes back filled with non-zero garbage (NaN for float32):
    a framing that leaves any sample of its buffer unwritten shows."""

    def __init__(self):
        self.filled = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, **kw):
        t = torch.empty(*args, **kw)
        if t.dtype in (torch.int16, torch.float32):
            t.fill_(float("nan") if t.is_floating_point() else 0x5A5A)
            self.filled.append(tuple(t.shape))
        return t


#: (layer, mode, the clip (nch, n) from a signal and n) of the framing
#: cases: int16 channels first, samples first, a row-strided view of a
#: longer master (as a spots item arrives), float64, mono 1-d, Layer I
L12_FRAMINGS = {
    "int16_channels_first": (2, mpeg.MODE_STEREO, lambda s, n: s[:, :n]),
    "int16_samples_first": (2, mpeg.MODE_JOINT, lambda s, n: s[:, :n].T),
    "int16_view_of_master": (2, mpeg.MODE_JOINT,
                             lambda s, n: s[:, 517:517 + n]),
    "float64": (2, mpeg.MODE_STEREO,
                lambda s, n: s[:, :n].T.astype(np.float64) + 0.25),
    "mono_1d": (2, mpeg.MODE_MONO, lambda s, n: s[0, :n]),
    "layer1_int16": (1, mpeg.MODE_JOINT, lambda s, n: s[:, :n].T),
}


@pytest.mark.parametrize("off", [0, 1, -1], ids=["whole", "plus1", "minus1"])
@pytest.mark.parametrize("case", L12_FRAMINGS)
def test_framing_copies_once_into_the_upload_buffer(case, off, monkeypatch):
    """``_layer12_frame`` into a buffer full of garbage gives the array,
    dtype and shape of the framing it replaced (zeros to whole frames),
    on clips that end on a frame boundary, one sample past one and one
    sample short of one; float input counts in ``float_frames_l12`` and
    int16 input does not; the buffer's upload has the framed dtype."""
    layer, mode, clip = L12_FRAMINGS[case]
    spf = 384 if layer == 1 else 1152
    master = pcm_of(layer, 2, 8).numpy()
    pcm = clip(master, 3 * spf + off)
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=192,
                        sample_rate_hz=48000)
    garbage = GarbageTorch()
    monkeypatch.setattr(E, "torch", garbage)
    f0 = E.float_frames_l12
    P, x = E._layer12_frame(pcm, cfg)
    F, want = frame_as_before(pcm, spf)
    assert garbage.filled == [want.shape]
    assert P.F == F and x.dtype == want.dtype and x.shape == want.shape
    np.testing.assert_array_equal(x, want)
    assert E.float_frames_l12 - f0 == (pcm.dtype != np.int16)
    up = E._layer12_upload(x, torch.device("cpu"))
    assert up.dtype == torch.from_numpy(want).dtype
    assert torch.equal(up, torch.from_numpy(want))


@pytest.mark.parametrize("case", ["int16_samples_first",
                                  "int16_view_of_master", "float64",
                                  "mono_1d", "layer1_int16"])
def test_framing_into_garbage_gives_the_same_bytes(case, monkeypatch):
    """``encode_layer12_fast`` with every int16 and float32 buffer that
    the encoder allocates pre-filled with garbage gives the bytes of an
    encode into fresh buffers: only the tail past the clip's last sample
    needs zeroing, and it is zeroed."""
    layer, mode, clip = L12_FRAMINGS[case]
    spf = 384 if layer == 1 else 1152
    pcm = clip(pcm_of(layer, 2, 8, seed=3).numpy(), 4 * spf + 5)
    cfg = EncoderConfig(layer=layer, mode=mode,
                        bitrate_kbps=64 if mode == mpeg.MODE_MONO else 192,
                        sample_rate_hz=48000)
    want = E.encode_layer12_fast(pcm, cfg, "cpu")
    garbage = GarbageTorch()
    monkeypatch.setattr(E, "torch", garbage)
    assert E.encode_layer12_fast(pcm, cfg, "cpu") == want
    assert (1 if mode == mpeg.MODE_MONO else 2, 5 * spf) in garbage.filled


@pytest.mark.parametrize("case", CASES)
def test_int16_analysis_holds_to_jax(case):
    """``analyze_frames`` on int16 PCM against the JAX package's
    ``analyze_frames`` on the same values as float32: the subband and
    joint samples within 1e-5, the SNR within 0.05 dB (noise-like
    input), scale factors, joint scale factors and scfsi exactly, as
    tests/test_torch_layer12.py holds the functions one by one."""
    layer, nch, sblimit, rate, F = CASES[case]
    pcm = pcm_of(layer, nch, F, seed=11)
    got = analyze(pcm, case, L12.analyze_frames)
    x = pcm.numpy().astype(np.float32)
    fb = (np.concatenate([np.zeros((nch, 64), np.float32), x[:, :-64]],
                         axis=1) if layer == 1 else x)
    ref = J.analyze_frames(jnp.asarray(x), jnp.asarray(fb), layer, None,
                           sblimit, nch, F, float(rate))
    assert got.keys() == ref.keys()
    for k in ("sb", "j_sample"):
        if k in ref:
            assert np.abs(got[k].numpy() - np.asarray(ref[k])).max() <= 1e-5
    snr = np.asarray(ref["snr"], np.float64)
    assert np.isfinite(snr).all()
    assert np.abs(got["snr"].numpy().astype(np.float64) - snr).max() <= 0.05
    for k in ("scalar", "scfsi", "j_scale"):
        if k in ref:
            np.testing.assert_array_equal(
                np.asarray(ref[k]).astype(np.int64), got[k].numpy(),
                err_msg=k)


# ---------------------------------------------------------------------------
# the back half as the analysis' second graph
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")


def dab(**kw):
    """The DAB configuration (Layer II, 48 kHz joint stereo, 192 kbit/s,
    the CRC), with `kw` changed."""
    return EncoderConfig(**dict(dict(
        layer=2, mode=mpeg.MODE_JOINT, bitrate_kbps=192,
        sample_rate_hz=48000, error_protection=True), **kw))


#: the chain's cases: (configuration, seconds of PCM)
CHAIN_CASES = {
    "l2_joint_crc": (dab(), 1.0),
    "l2_joint": (dab(error_protection=False), 1.0),
    "l1_joint_crc": (EncoderConfig(layer=1, mode=mpeg.MODE_JOINT,
                                   bitrate_kbps=384, sample_rate_hz=44100,
                                   error_protection=True), 0.5),
    "l1_stereo": (EncoderConfig(layer=1, mode=mpeg.MODE_STEREO,
                                bitrate_kbps=384, sample_rate_hz=44100), 0.5),
    "l2_mono_crc": (dab(mode=mpeg.MODE_MONO, bitrate_kbps=96), 1.0),
    "l2_mono": (dab(mode=mpeg.MODE_MONO, bitrate_kbps=96,
                    error_protection=False), 1.0),
}
#: the spots' lengths (10, 15, 20, 30 and 60 s) at a tenth: five keys at
#: a size that the CPU's plain K5 and K6 take in seconds
SPOTS_S = (1.0, 1.5, 2.0, 3.0, 6.0)


def framed(cfg, seconds, seed=0):
    """(plan, framed PCM) of `seconds` of ``pcm_of``'s signal under
    `cfg`: the clip's end falls inside its last frame."""
    nch = 1 if cfg.mode == mpeg.MODE_MONO else 2
    spf = 384 if cfg.layer == 1 else 1152
    n = int(seconds * cfg.sample_rate_hz)
    pcm = pcm_of(cfg.layer, nch, -(-n // spf), seed).numpy()[:, :n - 7]
    return E._layer12_frame(pcm.T, cfg)


@pytest.fixture
def stand_ins(monkeypatch):
    """Layer I/II graphs of their own (8 keys), zeroed counts, and the
    replayed route's host side on the CPU: ``graphs.cuda_graph`` a
    pooled stand-in capture (its replay runs Python; the tensors it
    makes are logged in the list returned) and ``graphs.on_stream`` the
    body and the keep on the current stream."""
    pools = []
    monkeypatch.setattr(L12, "GRAPHS", graphs.GraphCache(8))
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    monkeypatch.setattr(graphs, "cuda_graph",
                        lambda dev: pooled_stand_in(pools))
    monkeypatch.setattr(graphs, "on_stream",
                        lambda dev, body, keep: keep(body()[0]))
    return pools


@pytest.fixture
def rows(monkeypatch):
    """Each ``marshal_frames`` call's (values, lengths, CRC range), copied:
    a call's rows once a route has run (the warm-up's on a key's first
    call, a stand-in replay's after it)."""
    seen = []
    real = L12.marshal_frames

    def spy(*args):
        values, lengths, crc = real(*args)
        seen.append((values.clone(), lengths.clone(), crc))
        return values, lengths, crc

    monkeypatch.setattr(L12, "marshal_frames", spy)
    return seen


def chain_key(x, cfg, P):
    return L12._key(dict(pcm=torch.as_tensor(x)), P.layer, P.sblimit, P.nch,
                    P.sfreq_hz, E._back_key(cfg, P))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", ["l2_joint_crc", "l1_joint_crc",
                                  "l2_mono"])
def test_back_half_is_capture_safe(case, device):
    """The back half's torch part under an aten-op log, its tables made
    first (as the warm-up makes them) and K5's outputs given: the SMR
    stack, the quantizers with the joint samples and ``marshal_frames``
    make no host read of a device value, no tensor from host data, and
    run every op on the run's device."""
    cfg, seconds = CHAIN_CASES[case]
    P, x = framed(cfg, seconds)
    dev = torch.device(device)
    ana = L12.analyze_frames_eager(torch.as_tensor(x), P.layer, P.sblimit,
                                   P.nch, P.sfreq_hz)
    smr, scfsi = E._layer12_k5_inputs(ana, P, ana["snr"])
    alloc = A12.allocate_plain(smr, scfsi, P.layer, P.table, P.nch,
                               P.sblimit, P.adb, cfg.error_protection,
                               P.joint, cfg.mode)
    ana = {k: v.to(dev) for k, v in ana.items()}
    alloc = {k: v.to(dev) for k, v in alloc.items() if v is not None}
    E._layer12_elements(ana, cfg, P, alloc)          # the tables
    with OpLog() as log:
        got = E._layer12_k5_inputs(ana, P, ana["snr"])
        values, lengths, crc = E._layer12_elements(ana, cfg, P, alloc)
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 100
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device == dev for t in (*got[:1], values, lengths))
    assert (got[1] is None) == (P.layer == 1)
    assert (crc is None) == (not cfg.error_protection)


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_replayed_route_equals_the_op_by_op_route(stand_ins, rows, case):
    """The replayed route's host side (``_layer12_replayed``: the analysis
    and the back half as two stand-in graphs of one key) against the
    op-by-op route (``_layer12_eager``), three calls on one key (the
    warm-up and captures, then replays, the second on other PCM): each
    call's K6 buffer and marshalled values and lengths equal the op-by-op
    route's, and its bytes are in no replay's pool."""
    cfg, seconds = CHAIN_CASES[case]
    calls = [framed(cfg, seconds), framed(cfg, seconds, seed=1),
             framed(cfg, seconds)]
    bufs = []
    for P, x in calls:
        want = E._layer12_eager(x, cfg, P, CPU)
        got = E._layer12_replayed(x, cfg, P, CPU)
        (wv, wl, wc), (gv, gl, gc) = rows[-2:]
        assert torch.equal(gv, wv) and torch.equal(gl, wl) and gc == wc
        assert got.dtype == torch.uint8 and torch.equal(got, want)
        assert not any(shares_storage(got, made) for made in stand_ins)
        bufs.append(got)
    assert len(rows) == 6
    assert len(L12.GRAPHS) == 1
    assert graphs.by_stage()["l12_analysis"] == (1, 2)
    assert graphs.by_stage()["l12_back"] == (1, 2)
    assert torch.equal(bufs[0], bufs[2])
    assert not torch.equal(bufs[0], bufs[1])


def test_spots_lengths_replay_a_key_each(stand_ins, rows):
    """The spots' five lengths (at a tenth) under the DAB configuration,
    two passes: five keys, each captured on the first pass and replayed on
    the second, every call the op-by-op route's bytes and rows."""
    cfg = dab()
    for seed in (0, 1):
        for seconds in SPOTS_S:
            P, x = framed(cfg, seconds, seed)
            want = E._layer12_eager(x, cfg, P, CPU)
            assert torch.equal(E._layer12_replayed(x, cfg, P, CPU), want)
            (wv, wl, _), (gv, gl, _) = rows[-2:]
            assert torch.equal(gv, wv) and torch.equal(gl, wl)
    assert len(L12.GRAPHS) == 5
    assert graphs.by_stage()["l12_analysis"] == (5, 5)
    assert graphs.by_stage()["l12_back"] == (5, 5)


def test_bytes_outlive_the_next_call_of_their_key(stand_ins):
    """A call's K6 buffer is a copy: the next call of the same key, on
    other PCM, rewrites the key's static buffer and leaves the first
    call's bytes as they were."""
    cfg = dab()
    (P, x), (_, y) = framed(cfg, 1.0), framed(cfg, 1.0, seed=2)
    first = E._layer12_replayed(x, cfg, P, CPU)
    kept = first.clone()
    second = E._layer12_replayed(y, cfg, P, CPU)
    entry = L12.GRAPHS.get(chain_key(x, cfg, P))
    static = entry.outputs["l12_back"]["buf"]
    assert torch.equal(static, second)
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert first.untyped_storage().data_ptr() != \
        static.untyped_storage().data_ptr()


def test_back_key_holds_every_value_the_back_half_bakes_in():
    """Configurations that differ only in copyright, original, emphasis,
    bitrate, the CRC or the mode get other keys, and none is the key of
    the analysis alone; equal configurations share one."""
    def key(**kw):
        cfg = dab(**kw)
        P, x = framed(cfg, 0.2)
        return chain_key(x, cfg, P)

    base = key()
    assert key() == base
    others = [key(copyright=True), key(original=True), key(emphasis=1),
              key(bitrate_kbps=256), key(error_protection=False),
              key(mode=mpeg.MODE_STEREO)]
    assert all(k != base for k in others)
    assert len(set(others)) == len(others)
    cfg = dab()
    P, x = framed(cfg, 0.2)
    assert L12._key(dict(pcm=torch.as_tensor(x)), P.layer, P.sblimit, P.nch,
                    P.sfreq_hz) not in {base, *others}
    assert set(dict(E._back_key(cfg, P)[0])) == set(E.BACK_FIELDS)
