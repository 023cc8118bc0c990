"""Layers I/II in the port: mp3tpu_torch.ops.layer12 against
mp3tpu.ops.jaxlayer12, and the port's Layer I/II encoder, on the CPU.

Tolerances: the filterbank within 1e-5 absolute on scaled samples; the
model-2 SNR within 0.05 dB on noise-like input, and on tonal input no
further from the JAX function's float64 evaluation than 4x the JAX
function's own float32 result (its quiet lines sit at the FFT's float32
round-off); window indexing, constants, scale factors, scfsi classes,
quantizers and the element marshalling exactly.  Whole streams follow
tests/test_layer12_fast.py (same length and first 3 bytes as the
reference stream, decoded SNR at most 0.5 dB below it),
tests/test_stream.py (windowed stream equals the one-shot encode) and
tests/test_lsf.py (MPEG-2 LSF round trips).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu import encoder as jencoder
from mp3tpu.decoder import layer12 as dec12
from mp3tpu.ops import jaxlayer12 as J
from mp3tpu.runtime.wav import read_wav
from mp3tpu.tables import mpeg
from mp3tpu_torch import encoder as tencoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.ops import dsp
from mp3tpu_torch.ops import layer12 as L12

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

DT = dsp.device_tables(dsp.numpy_constants(), "cpu")
_DELAY = {1: 545, 2: 481}  # synthesis+analysis filterbank delay


def _noise(n, seed=0):
    return (np.random.RandomState(seed).randn(n) * 6000).astype(np.float32)


def _tone(n, rate=44100.0):
    t = np.arange(n) / rate
    return (12000 * np.sin(2 * np.pi * 1000 * t)
            + 3000 * np.sin(2 * np.pi * 5200 * t)).astype(np.float32)


@pytest.mark.parametrize("layer", [1, 2])
def test_subband_frames_within_1e5(layer):
    spf, ngroups = (384, 1) if layer == 1 else (1152, 3)
    blocks = (_noise(6 * spf, layer) / 32768.0).reshape(6, spf)
    ref = np.asarray(J.subband_frames(jnp.asarray(blocks), ngroups))
    got = L12.subband_frames(torch.tensor(blocks), ngroups, DT).numpy()
    assert got.shape == ref.shape == (6, ngroups, 12, 32)
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("hz", [44100.0, 48000.0, 32000.0, 22050.0,
                                24000.0, 16000.0])
def test_psy_constants_equal_jax(hz):
    ref, got = J._psy_constants(hz), L12.psy_constants(hz)
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


@pytest.mark.parametrize("layer", [1, 2])
def test_psy_windows_equal_jax(layer):
    stream = _noise(7 * 1152, 3)
    ref = np.asarray(J.psy_windows(jnp.asarray(stream), 7, layer))
    got = L12.psy_windows(torch.tensor(stream), 7, layer).numpy()
    np.testing.assert_array_equal(ref, got)


def _snr_both(stream, layer, nframes, hz=44100.0):
    win = np.asarray(J.psy_windows(jnp.asarray(stream), nframes, layer))
    ref = np.asarray(J.psy_snr32(jnp.asarray(win), layer,
                                 J._psy_constants(hz)), np.float64)
    C = L12.device_constants(hz, torch.device("cpu"))
    got = L12.psy_snr32(torch.tensor(win), layer, C).numpy()
    return win, ref, got.astype(np.float64)


@pytest.mark.parametrize("layer", [1, 2])
def test_psy_snr32_noise_within_005db(layer):
    _, ref, got = _snr_both(_noise(9 * 1152, 5 + layer), layer, 9)
    assert np.isfinite(ref).all()
    assert np.abs(got - ref).max() <= 0.05


@pytest.mark.parametrize("layer", [1, 2])
def test_psy_snr32_tonal_within_4x_of_jax_f32(monkeypatch, layer):
    win, ref, got = _snr_both(_tone(9 * 1152), layer, 9)
    # the JAX function evaluated in float64 (its float32 casts widened)
    monkeypatch.setattr(J, "F32", jnp.float64)
    ref64 = np.asarray(J.psy_snr32(jnp.asarray(win, jnp.float64), layer,
                                   J._psy_constants(44100.0)), np.float64)
    own = np.sqrt(np.mean((ref - ref64) ** 2))
    port = np.sqrt(np.mean((got - ref64) ** 2))
    assert own > 0
    assert port <= 4.0 * own + 1e-6, (port, own)


def _random_sb(seed, F=5, G=3):
    rng = np.random.RandomState(seed)
    amp = rng.choice([1e-6, 1e-3, 0.05, 0.5, 1.5], size=(F, G, 1, 32))
    return (rng.randn(F, G, 12, 32) * amp).astype(np.float32)


@pytest.mark.parametrize("sblimit", [27, 30, 32])
def test_scale_factors_and_scfsi_exact(sblimit):
    sb = _random_sb(sblimit)
    ref = np.asarray(J.scale_factors(jnp.asarray(sb), sblimit))
    got = L12.scale_factors(torch.tensor(sb), sblimit).numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), got)
    scf_r, new_r = J.scfsi_pattern(jnp.asarray(ref))
    scf_g, new_g = L12.scfsi_pattern(torch.tensor(got))
    assert len(np.unique(np.asarray(scf_r))) == 4
    np.testing.assert_array_equal(np.asarray(scf_r, np.int64),
                                  scf_g.numpy())
    np.testing.assert_array_equal(np.asarray(new_r, np.int64),
                                  new_g.numpy())


@pytest.mark.parametrize("layer,table", [(1, None), (2, 0), (2, 2)])
def test_quantizers_exact(layer, table):
    G = 1 if layer == 1 else 3
    sb = _random_sb(7 + layer, G=G)
    scalar = L12.scale_factors(torch.tensor(sb), 32).numpy()
    rng = np.random.RandomState(layer)
    ba = rng.randint(0, 15 if layer == 1 else 16, size=(sb.shape[0], 32))
    if layer == 1:
        ref = J.quantize_l1(jnp.asarray(sb), jnp.asarray(scalar),
                            jnp.asarray(ba))
        got = L12.quantize_l1(torch.tensor(sb), torch.tensor(scalar),
                              torch.tensor(ba))
    else:
        ref = J.quantize_l2(jnp.asarray(sb), jnp.asarray(scalar),
                            jnp.asarray(ba), table)
        got = L12.quantize_l2(torch.tensor(sb), torch.tensor(scalar),
                              torch.tensor(ba), table)
    np.testing.assert_array_equal(np.asarray(ref, np.int64), got.numpy())


CASES = [
    ("l2_sine_st_192", 2, mpeg.MODE_STEREO, 192, 44100),
    ("l2_noise_j_128", 2, mpeg.MODE_JOINT, 128, 44100),
    ("l2_sweep_mono_96", 2, mpeg.MODE_MONO, 96, 44100),
    ("l2_trans_st_256_48k", 2, mpeg.MODE_STEREO, 256, 48000),
    ("l1_sine_st_384", 1, mpeg.MODE_STEREO, 384, 44100),
    ("l1_sweep_j_256", 1, mpeg.MODE_JOINT, 256, 44100),
]


def _snr(orig, deco, d):
    n = min(len(orig) - d, len(deco) - d)
    o = orig[:n].astype(np.float64)
    err = o - deco[d:d + n]
    return 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))


@pytest.mark.parametrize("name,layer,mode,kbps,rate", CASES)
def test_port_matches_reference_quality(golden_dir, name, layer, mode, kbps,
                                        rate):
    pcm, got_rate = read_wav(os.path.join(golden_dir, f"{name}.wav"))
    assert got_rate == rate
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    fast = tencoder.encode_layer12_fast(pcm, cfg, "cpu")
    ref = open(os.path.join(golden_dir, f"{name}.ref.mp{layer}"),
               "rb").read()
    assert len(fast) == len(ref)
    assert fast[:3] == ref[:3]
    deco_f, _ = dec12.decode(fast)
    deco_r, _ = dec12.decode(ref)
    d = _DELAY[layer]
    for ch in range(pcm.shape[1]):
        s_f = _snr(pcm[:, ch], deco_f[:, ch] * 32768.0, d)
        s_r = _snr(pcm[:, ch], deco_r[:, ch] * 32768.0, d)
        assert s_f >= s_r - 0.5, (name, ch, s_f, s_r)


def test_port_crc_stream_decodes(golden_dir):
    pcm, rate = read_wav(os.path.join(golden_dir,
                                      "l2_noise_st_192_crc.wav"))
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=rate, error_protection=True)
    fast = tencoder.encode_layer12_fast(pcm, cfg, "cpu")
    deco, _ = dec12.decode(fast)
    assert len(deco) >= len(pcm) - 1152
    assert _snr(pcm[:, 0], deco[:, 0] * 32768.0, _DELAY[2]) > 0.0


@pytest.mark.parametrize("name,layer,mode,kbps,crc", [
    ("l2_noise_j_128", 2, mpeg.MODE_JOINT, 128, False),
    ("l1_sweep_j_256", 1, mpeg.MODE_JOINT, 256, False),
    ("l2_noise_st_192_crc", 2, mpeg.MODE_STEREO, 192, True),
    ("l2_sweep_mono_96", 2, mpeg.MODE_MONO, 96, True)])
def test_marshal_layer12_equals_jax(golden_dir, monkeypatch, name, layer,
                                    mode, kbps, crc):
    """The port's element marshalling equals the JAX package's on the
    arguments the host route (``chip_smoke.l12_host_route``, the
    yardstick of the card chain) gives it (joint stereo, CRC, mono)."""
    from chip_smoke import l12_host_route
    captured = []
    real = tencoder._marshal_layer12

    def capture(*args):
        captured.append(args)
        return real(*args)

    monkeypatch.setattr(tencoder, "_marshal_layer12", capture)
    pcm, rate = read_wav(os.path.join(golden_dir, f"{name}.wav"))
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate, error_protection=crc)
    l12_host_route(pcm if mode != mpeg.MODE_MONO else pcm[:, :1], cfg,
                   "cpu")
    args = captured[0]
    vr, lr = jencoder._marshal_layer12(*args)
    vg, lg = real(*args)
    assert vr.dtype == vg.dtype and lr.dtype == lg.dtype
    np.testing.assert_array_equal(lr, lg)
    np.testing.assert_array_equal(vr, vg)


@pytest.mark.parametrize("layer,kbps", [(2, 192), (1, 384)])
def test_stream_layer12_matches_oneshot(layer, kbps):
    rng = np.random.RandomState(3)
    rate = 44100
    t = np.arange(int(2.2 * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(len(t))
    pcm = np.clip(x * 20000, -32768, 32767).astype(np.int16)
    pcm = np.stack([pcm, (pcm * 0.6).astype(np.int16)], 1)

    def cfg():
        return EncoderConfig(layer=layer, mode=mpeg.MODE_STEREO,
                             bitrate_kbps=kbps, sample_rate_hz=rate)

    one = tencoder.encode_layer12_fast(pcm, cfg(), "cpu")
    pieces = (pcm[s:s + 7001] for s in range(0, len(pcm), 7001))
    streamed = b"".join(tencoder.encode_layer12_stream(pieces, cfg(), "cpu",
                                                       window_frames=16))
    assert streamed == one


L12_LSF_CASES = [
    (2, 22050, 64, mpeg.MODE_MONO),
    (2, 24000, 96, mpeg.MODE_STEREO),
    (2, 16000, 48, mpeg.MODE_MONO),
    (1, 22050, 96, mpeg.MODE_MONO),
    (1, 24000, 128, mpeg.MODE_STEREO),
]


@pytest.mark.parametrize("layer,rate,kbps,mode", L12_LSF_CASES)
def test_lsf_layer12_roundtrip(layer, rate, kbps, mode):
    t = np.arange(int(0.5 * rate)) / rate
    rng = np.random.RandomState(5)
    x = np.clip((0.25 * np.sin(2 * np.pi * 440 * t)
                 + 0.02 * rng.randn(len(t))) * 20000,
                -32768, 32767).astype(np.int16)
    pcm = (x if mode == mpeg.MODE_MONO
           else np.stack([x, (x * 0.5).astype(np.int16)], 1))
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    out = tencoder.encode_layer12_fast(pcm, cfg, "cpu")
    assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
    assert ((out[1] >> 3) & 1) == 0, "version bit must be 0 (MPEG-2)"
    assert 4 - ((out[1] >> 1) & 3) == layer
    spf = 384 if layer == 1 else 1152
    bits_per_slot = 32 if layer == 1 else 8
    fsize = int((spf / (rate / 1000.0)) * (kbps / bits_per_slot)) \
        * (bits_per_slot // 8)
    assert out[fsize] == 0xFF and (out[fsize + 1] & 0xF0) == 0xF0
    dec, drate = dec12.decode(out)
    assert drate == rate
    ref2 = np.atleast_2d(pcm.T).T
    d = _DELAY[layer]
    n = min(len(ref2) - d, len(dec) - d)
    o = ref2[:n, 0].astype(np.float64)
    err = o - dec[d:d + n, 0] * 32768.0
    snr = 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))
    assert snr > 20.0, snr
