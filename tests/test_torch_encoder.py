"""The whole slice: mp3tpu_torch.encoder.encode_layer3_fast on the CPU.

Segment planning and payload stitching are host numpy and must equal
the JAX package's helpers exactly.  Whole streams are not compared byte
for byte with the JAX package (float32 round-off moves single quantized
lines); they are held to the frame grid, to the reference encoder's
decoded-SNR bars, to the JAX package's decoded SNR within 1 dB, and to
libmpg123 agreement.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mp3tpu import encoder as jencoder
from mp3tpu.config import EncoderConfig as JEncoderConfig
from mp3tpu.decoder import decode_mp3
from mp3tpu.decoder.layer3 import snr_db
from mp3tpu.runtime import mpg123
from mp3tpu.runtime.wav import read_wav
from mp3tpu.tables import mpeg
from mp3tpu_torch import encoder as tencoder
from mp3tpu_torch.config import EncoderConfig

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

CASES = [
    ("sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("noise_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("q_sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("q_mix_st_128", mpeg.MODE_STEREO, 128, 44100),
]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("G", [1, 2, 92, 256, 257, 1024, 2048, 2304, 2305,
                               4594, 9000])
def test_plan_segments_matches_jax(G):
    assert tencoder._plan_segments(G) == jencoder._plan_segments(G)
    assert tencoder._plan_segments(G, (128,)) == \
        jencoder._plan_segments(G, (128,))


def _fake_segments(rng, plan, lanes):
    sides, flats = [], []
    for _, _, n_pad in plan:
        p23 = rng.randint(0, 700, lanes * n_pad)
        p23[rng.rand(lanes * n_pad) < 0.2] = 0
        side = np.zeros((lanes * n_pad, 19), np.int16)
        side[:, 0] = p23
        words = int(((p23 + 31) >> 5).sum())
        sides.append(side)
        flats.append(rng.randint(0, 2 ** 32, words + 40, dtype=np.uint64)
                     .astype(np.uint32))
    return sides, flats


@pytest.mark.parametrize("nch,lanes,lane0,G", [
    (1, 1, 0, None), (2, 2, 0, None),
    # a corpus group: clip b=1 of 2 stereo clips, shorter than the plan
    # (tail granules past G excluded from spans and offsets together)
    (2, 4, 2, 300), (2, 4, 0, 1030), (1, 3, 2, 5)])
def test_stitch_flat_matches_jax(nch, lanes, lane0, G):
    rng = np.random.RandomState(nch * 7 + lanes + (G or 0))
    plan = jencoder._plan_segments(1300 if G is None else max(G, 1300),
                                   (256, 1024))
    sides, flats = _fake_segments(rng, plan, lanes)
    ref = jencoder._stitch_flat(plan, sides, flats, nch, lane0=lane0, G=G)
    got = tencoder._stitch_flat(plan, sides, flats, nch, lane0=lane0, G=G)
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int64


@pytest.fixture(scope="module")
def streams(golden_dir):
    """Each fixture encoded once by the port on the CPU."""
    out = {}
    for name, mode, kbps, rate in CASES:
        pcm, _ = read_wav(os.path.join(golden_dir, f"{name}.wav"))
        cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        data = pcm[:, 0] if mode == mpeg.MODE_MONO else pcm
        out[name] = (pcm, tencoder.encode_layer3_fast(data, cfg,
                                                      device="cpu"))
    return out


@pytest.mark.parametrize("name,mode,kbps,rate", CASES,
                         ids=[c[0] for c in CASES])
def test_slice_beats_reference_snr(golden_dir, streams, name, mode, kbps,
                                   rate):
    with open(os.path.join(golden_dir, "ref_snr.json")) as f:
        ref = json.load(f)
    pcm, out = streams[name]
    # all frames complete on the CBR grid + one trailing flush byte
    fsize = (144000 * kbps) // rate
    nframes = -(-pcm.shape[0] // 1152)
    assert len(out) == nframes * fsize + 1, (len(out), nframes, fsize)
    assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
    for f in range(nframes):
        assert out[f * fsize] == 0xFF and (out[f * fsize + 1] & 0xF0) == 0xF0
    dec, drate = decode_mp3(out)
    assert drate == rate
    for c in range(min(dec.shape[1], pcm.shape[1])):
        snr = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
        assert snr >= ref[name][c], (name, c, snr, ref[name][c])


def test_segments_carry_state(golden_dir):
    """Small super-chunks cut a transient clip into several segments; the
    automaton state, the reservoir level and the 4-block halo carried from
    segment to segment must give a valid stream at the reference's bars."""
    pcm, _ = read_wav(os.path.join(golden_dir, "trans_st_128.wav"))
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    nframes = -(-pcm.shape[0] // 1152)
    assert len(tencoder._plan_segments(2 * nframes, (64,))) >= 3
    out = tencoder.encode_layer3_fast(pcm, cfg, device="cpu", chunk=64)
    assert len(out) == nframes * 417 + 1
    with open(os.path.join(golden_dir, "ref_snr.json")) as f:
        ref = json.load(f)["trans_st_128"]
    dec, _ = decode_mp3(out)
    for c in range(2):
        assert float(snr_db(pcm[:, c].astype(np.float64), dec[:, c])) \
            >= ref[c]


def test_slice_within_1db_of_jax(streams):
    pcm, out = streams["noise_mono_64"]
    cfg = JEncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                         sample_rate_hz=44100)
    ref = jencoder.encode_layer3_fast(pcm[:, 0], cfg)
    assert len(ref) == len(out)
    x = pcm[:, 0].astype(np.float64)
    s_ref = float(snr_db(x, decode_mp3(ref)[0][:, 0]))
    s_got = float(snr_db(x, decode_mp3(out)[0][:, 0]))
    assert abs(s_got - s_ref) <= 1.0, (s_got, s_ref)


@pytest.mark.parametrize("delta,pw,path", [(28, 8, "rebucket"),
                                           (900, 96, "guard")])
def test_retry_paths_keep_the_stream_valid(golden_dir, monkeypatch, delta,
                                           pw, path):
    """A payload row too narrow for a granule is re-bucketed wider; an
    over-optimistic reservoir prediction (large delta) overdraws and the
    guard clamps the budgets and re-encodes.  Both must still give a
    valid stream at the reference's quality bar."""
    guard_bad, widths = [], []
    real_guard = tencoder.resv_guard
    real_final = tencoder.Layer3SegmentEncoder.encode_final

    def guard(*a, **k):
        res = real_guard(*a, **k)
        guard_bad.append(res[0])
        return res

    def final(self, *a, **k):
        widths.append(k["payload_words"])
        return real_final(self, *a, **k)

    monkeypatch.setattr(tencoder, "resv_guard", guard)
    monkeypatch.setattr(tencoder.Layer3SegmentEncoder, "encode_final",
                        final)
    pcm, _ = read_wav(os.path.join(golden_dir, "noise_st_128.wav"))
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    out = tencoder.encode_layer3_fast(pcm, cfg, device="cpu", delta=delta,
                                      pw=pw)
    if path == "rebucket":
        assert widths[0] == pw and max(widths) > pw, widths
    else:
        assert guard_bad[0] and not guard_bad[-1], guard_bad
    assert len(out) == -(-pcm.shape[0] // 1152) * 417 + 1
    with open(os.path.join(golden_dir, "ref_snr.json")) as f:
        ref = json.load(f)["noise_st_128"]
    dec, _ = decode_mp3(out)
    for c in range(2):
        assert float(snr_db(pcm[:, c].astype(np.float64), dec[:, c])) \
            >= ref[c]


def test_mpg123_agrees_with_in_repo_decoder(streams):
    if not mpg123.available():
        pytest.skip("libmpg123 not present")
    for name in ("noise_mono_64", "q_mix_st_128"):
        pcm, out = streams[name]
        ours = decode_mp3(out)[0] * 32768.0
        theirs, rate = mpg123.decode(out)
        assert rate == 44100 and theirs.shape[1] == pcm.shape[1]
        for c in range(pcm.shape[1]):
            n = min(len(ours), len(theirs))
            e = ours[:n, c] - theirs[:n, c]
            agree = 10 * np.log10(max((ours[:n, c] ** 2).sum(), 1e-30)
                                  / max((e ** 2).sum(), 1e-30))
            assert agree > 20.0, (name, c, agree)


def test_cuda_is_never_picked_silently():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                        sample_rate_hz=44100)
    with pytest.raises(RuntimeError, match="CUDA"):
        tencoder.encode_layer3_fast(np.zeros(1152, np.int16), cfg,
                                    device="cuda")


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "import mp3tpu_torch\n"
        "import mp3tpu_torch.cli\n"
        "import mp3tpu_torch.ops.layer12\n"
        "from mp3tpu_torch.encoder import (encode_layer3_fast,"
        " encode_layer3_stream, encode_layer12_fast)\n"
        "from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder\n"
        "from mp3tpu_torch.config import EncoderConfig\n"
        "from mp3tpu_torch.tables import mpeg\n"
        "rng = np.random.RandomState(0)\n"
        "pcm = (rng.randn(4 * 1152) * 3000).astype(np.int16)\n"
        "for rate, kbps in ((44100, 64), (22050, 32)):\n"
        "    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO,"
        " bitrate_kbps=kbps, sample_rate_hz=rate)\n"
        "    out = encode_layer3_fast(pcm, cfg, device='cpu')\n"
        "    assert len(out) > 100 and out[0] == 0xFF\n"
        "    assert b''.join(encode_layer3_stream([pcm], cfg, 'cpu',"
        " window=8))[0] == 0xFF\n"
        "cfg = EncoderConfig(layer=2, mode=mpeg.MODE_MONO, bitrate_kbps=64,"
        " sample_rate_hz=44100)\n"
        "assert encode_layer12_fast(pcm, cfg, 'cpu')[0] == 0xFF\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
