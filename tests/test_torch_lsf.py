"""MPEG-2 LSF (16/22.05/24 kHz) Layer III in the port, and the per-encode
metrics of encode_layer3_fast, on the CPU.

LSF scalefactor selection and emission are integer work and must equal
the JAX package exactly on random scalefactors (long and short, preflag
0 and 1, values past every limit).  Whole LSF streams are held to
tests/test_lsf.py's criterion (MPEG-2 version bit, interior frames on
the CBR grid, decoded SNR > 25 dB) and, on one case, to the JAX fast
path's decoded SNR within 1 dB.  The metrics dict must carry the JAX
package's keys with the same frame, byte, segment and retry counts.
NaN/Inf input follows tests/test_recovery.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu import encoder as jencoder
from mp3tpu.config import EncoderConfig as JEncoderConfig
from mp3tpu.decoder import decode_mp3
from mp3tpu.decoder.layer3 import snr_db
from mp3tpu.ops import jaxbits, jaxloop
from mp3tpu.runtime.profiling import Profiler as JProfiler
from mp3tpu.tables import mpeg
from mp3tpu_torch import encoder as tencoder
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import bits, loop
from mp3tpu_torch.runtime.profiling import Profiler

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

RATES =[(22050, 64), (24000, 64), (16000, 48)]


def _signal(rate, seconds=0.5, seed=5):
    """tests/test_lsf.py's signal: a 440 Hz tone in light noise."""
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.RandomState(seed)
    x = 0.25 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(len(t))
    return np.clip(x * 20000, -32768, 32767).astype(np.int16)


def _check_cbr(out, rate, kbps):
    """Every interior frame on the CBR grid (the tail is cut mid-frame at
    flush), version bit 0 (MPEG-2)."""
    fsize = 72000 * kbps // rate
    assert out[0] == 0xFF and (out[1] & 0xF0) == 0xF0
    assert ((out[1] >> 3) & 1) == 0, "version bit must be 0 (MPEG-2)"
    nfull = (len(out) - 1) // fsize
    assert nfull >= 5
    for k in range(nfull - 1):
        off = k * fsize
        assert out[off] == 0xFF and (out[off + 1] & 0xF0) == 0xF0, off


def _random_sf(seed, G=96):
    """Scalefactors from 0 to past every LSF limit (MAX_SFAC_TAB up to
    5 bits per partition), a third of the granules short, half with
    preflag."""
    rng = np.random.RandomState(seed)
    top = rng.choice([1, 2, 4, 8, 16, 40], size=(G, 1))
    sf_l = (rng.rand(G, 21) * top).astype(np.int32)
    sf_s = (rng.rand(G, 12, 3) * top[:, :, None]).astype(np.int32)
    sf_l[rng.rand(G, 21) < 0.3] = 0
    is_short = rng.rand(G) < 0.33
    preflag = (rng.rand(G) < 0.5).astype(np.int32)
    return sf_l, sf_s, is_short, preflag


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_bitcount_lsf_exact(seed):
    sf_l, sf_s, is_short, preflag = _random_sf(seed)
    ref = jaxloop.scale_bitcount_lsf(jnp.asarray(sf_l), jnp.asarray(sf_s),
                                     jnp.asarray(is_short),
                                     jnp.asarray(preflag))
    ST = loop.device_tables(loop.static_tables(mpeg.MPEG2_LSF, 0), "cpu")
    got = loop.scale_bitcount_lsf(torch.tensor(sf_l), torch.tensor(sf_s),
                                  torch.tensor(is_short),
                                  torch.tensor(preflag), ST)
    overflow = np.asarray(ref[2])
    assert overflow.any() and not overflow.all()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_scalefac_elements_lsf_exact(seed):
    sf_l, sf_s, is_short, preflag = _random_sf(seed)
    sf_l, sf_s = np.minimum(sf_l, 15), np.minimum(sf_s, 15)
    # compress values as the loop selects them, both tables
    ST = loop.device_tables(loop.static_tables(mpeg.MPEG2_LSF, 1), "cpu")
    compress = loop.scale_bitcount_lsf(
        torch.tensor(sf_l), torch.tensor(sf_s), torch.tensor(is_short),
        torch.tensor(preflag), ST)[0].numpy()
    assert (compress >= 500).any() and (compress < 500).any()
    vj, lj = jaxbits.scalefac_elements_lsf(
        jnp.asarray(sf_l), jnp.asarray(sf_s), jnp.asarray(compress),
        jnp.asarray(is_short))
    vt, lt = bits.scalefac_elements_lsf(
        torch.tensor(sf_l), torch.tensor(sf_s), torch.tensor(compress),
        torch.tensor(is_short), bits.device_tables("cpu"))
    np.testing.assert_array_equal(np.asarray(vj, np.int64), vt.numpy())
    np.testing.assert_array_equal(np.asarray(lj, np.int64), lt.numpy())


def test_lsf_segment_has_no_scfsi():
    """An LSF segment returns no scfsi flags (MPEG-2 has none)."""
    enc = Layer3SegmentEncoder(mpeg.MPEG2_LSF, 0, "cpu")
    rng = np.random.RandomState(1)
    bl = (rng.randn(1, 4 + 8, 576) * 2000).astype(np.int16)
    h = enc(torch.tensor(bl), np.zeros(1, np.int32), 0, 96, 1,
            bits.payload_cap_words(8, 8 * 208, 72, 2040, 8), 8, 752, 2040,
            1, 28)
    assert "scfsi" not in h and "sf_fix" not in h
    assert int((h["side"][:, 0] > 0).sum()) == 8


@pytest.fixture(scope="module")
def lsf_streams():
    out = {}
    for rate, kbps in RATES:
        cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        out[rate] = tencoder.encode_layer3_fast(_signal(rate), cfg,
                                                device="cpu")
    return out


@pytest.mark.parametrize("rate,kbps", RATES)
def test_port_lsf_roundtrip(lsf_streams, rate, kbps):
    pcm = _signal(rate)
    out = lsf_streams[rate]
    _check_cbr(out, rate, kbps)
    dec, drate = decode_mp3(out)
    assert drate == rate
    snr = float(snr_db(pcm.astype(np.float64), dec[:, 0]))
    assert snr > 25.0, snr


def test_port_lsf_within_1db_of_jax(lsf_streams):
    rate, kbps = RATES[0]
    pcm = _signal(rate)
    cfg = JEncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=kbps,
                         sample_rate_hz=rate)
    ref = jencoder.encode_layer3_fast(pcm, cfg)
    x = pcm.astype(np.float64)
    s_ref = float(snr_db(x, decode_mp3(ref)[0][:, 0]))
    s_got = float(snr_db(x, decode_mp3(lsf_streams[rate])[0][:, 0]))
    assert abs(s_got - s_ref) <= 1.0, (s_got, s_ref)


@pytest.mark.parametrize("rate,kbps,seconds", [(44100, 64, 0.8),
                                               (22050, 32, 0.5)])
def test_encode_metrics_match_jax(rate, kbps, seconds):
    """prof.meta carries the JAX package's per-encode keys; frames,
    bytes, segments and guard retries agree, nothing degraded."""
    pcm = _signal(rate, seconds=seconds, seed=11)
    metas = []
    for encode, Config, Prof in (
            (lambda c, p: jencoder.encode_layer3_fast(pcm, c, prof=p),
             JEncoderConfig, JProfiler),
            (lambda c, p: tencoder.encode_layer3_fast(pcm, c, "cpu", prof=p),
             EncoderConfig, Profiler)):
        cfg = Config(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=kbps,
                     sample_rate_hz=rate)
        prof = Prof()
        out = encode(cfg, prof)
        assert prof.meta["bytes"] == len(out)
        metas.append(prof.meta)
    ref, got = metas
    assert ref.keys() == got.keys()
    for k in ("frames", "segments", "guard_retries", "audio_s", "resv_delta"):
        assert got[k] == ref[k], k
    if rate == 44100:          # MPEG-1: frames x frame size + flush byte
        assert got["bytes"] == ref["bytes"]
    assert got["nonfinite_granules"] == ref["nonfinite_granules"] == 0
    assert abs(got["mean_p23"] - ref["mean_p23"]) <= 0.05 * ref["mean_p23"]


def test_nan_pcm_still_encodes():
    """NaN/Inf float PCM is sanitized at the host boundary; the stream
    stays valid and decodable."""
    rng = np.random.RandomState(7)
    t = np.arange(int(0.5 * 44100)) / 44100
    pcm = (0.3 * np.sin(2 * np.pi * 500 * t) + 0.04 * rng.randn(len(t))) \
        * 22000
    pcm[1000:1200] = np.nan
    pcm[3000:3050] = np.inf
    pcm[5000:5050] = -np.inf
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                        sample_rate_hz=44100)
    prof = Profiler()
    out = tencoder.encode_layer3_fast(pcm[:, None], cfg, "cpu", prof=prof)
    assert out[0] == 0xFF
    assert prof.meta["nonfinite_granules"] == 0
    dec, rate = decode_mp3(out)
    assert rate == 44100 and np.all(np.isfinite(dec))


def test_nonfinite_analysis_degrades_to_silence():
    """A granule whose analysis goes non-finite is zeroed (valid stream)
    and counted in n_nonfinite."""
    blocks = np.zeros((1, 4 + 16, 576), np.float32)
    blocks[0, 4:] = 1000.0
    blocks[0, 10, :10] = np.nan          # poison one granule's input
    enc = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    ana = enc.analyze_demand_fused(torch.tensor(blocks),
                                   torch.zeros(1, dtype=torch.int32))
    assert int(ana["n_nonfinite"]) >= 1
    assert bool(torch.isfinite(ana["xr"]).all())
    assert bool(torch.isfinite(ana["pe"]).all())
    assert bool((ana["p23"] >= 0).all())
