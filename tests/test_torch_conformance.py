"""Third-party decoder conformance of the port's streams: the port's
encoders on the CPU, decoded by the system libmpg123 through the port's
own binding (``mp3tpu_torch.runtime.mpg123``).

The cases of ``tests/test_conformance.py`` at the same bars (Layer III
stereo, mono and LSF 22.05 kHz, Layer II, Layer I, a CRC-protected Layer
III stream, dense count1 content), the fast-path Layer III CRC word of
``tests/test_crc.py`` at mono and stereo, and scfsi firing on the
stationary tone of ``tests/test_scfsi.py``; each stream also goes
through libmpg123.
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.decoder import decode_mp3
from mp3tpu_torch.decoder.layer3 import BitReader, _parse_side_info, snr_db
from mp3tpu_torch.encoder import encode_layer3_fast, encode_layer12_fast
from mp3tpu_torch.numpy_ref.bitstream import _update_crc16
from mp3tpu_torch.runtime import mpg123
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools.quality import best_lag_snr

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not mpg123.available(),
                                reason="libmpg123 not present")


def _sig(rate, seconds=1.0, stereo=False):
    """tests/test_conformance.py's tone with a little noise."""
    rng = np.random.RandomState(7)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(len(t))
    x = np.clip(x * 22000, -32768, 32767).astype(np.int16)
    return np.stack([x, (x * 0.6).astype(np.int16)]) if stereo else x


CASES = [
    ("l3_st_128", 3, mpeg.MODE_STEREO, 128, 44100, 12.0),
    ("l3_mono_64", 3, mpeg.MODE_MONO, 64, 44100, 12.0),
    ("l3_lsf_22k_48", 3, mpeg.MODE_MONO, 48, 22050, 12.0),
    ("l2_st_192", 2, mpeg.MODE_STEREO, 192, 44100, 15.0),
    ("l1_st_384", 1, mpeg.MODE_STEREO, 384, 44100, 15.0),
]


@pytest.mark.parametrize("name,layer,mode,kbps,rate,bar", CASES,
                         ids=[c[0] for c in CASES])
def test_mpg123_decodes_our_stream(name, layer, mode, kbps, rate, bar):
    stereo = mode == mpeg.MODE_STEREO
    pcm = _sig(rate, stereo=stereo)
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    if layer == 3:
        out = encode_layer3_fast(pcm, cfg, "cpu")
    else:
        out = encode_layer12_fast(pcm.T if stereo else pcm, cfg, "cpu")
    dec, drate = mpg123.decode(out)
    assert drate == rate
    assert dec.shape[1] == (2 if stereo else 1)
    ref0 = pcm[0] if stereo else pcm
    assert dec.shape[0] >= len(ref0) - 2 * 1152, (dec.shape, len(ref0))
    snr = best_lag_snr(ref0, dec[:, 0])
    assert snr > bar, (name, snr)
    if stereo:
        snr1 = best_lag_snr(pcm[1], dec[:, 1])
        assert snr1 > bar - 3.0, (name, snr1)


def test_mpg123_crc_stream():
    """An error-protected (CRC-16) Layer III stream passes mpg123's CRC
    handling."""
    rate = 44100
    pcm = _sig(rate)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=96,
                        sample_rate_hz=rate, error_protection=True)
    out = encode_layer3_fast(pcm, cfg, "cpu")
    dec, drate = mpg123.decode(out)
    assert drate == rate
    assert best_lag_snr(pcm, dec[:, 0]) > 12.0


def test_mpg123_agrees_on_dense_count1_content():
    """Full-band noise (count1-heavy) decodes near-identically in the
    in-repo decoder and libmpg123: count1 quads are emitted in the
    conformant (v<<3)|(w<<2)|(x<<1)|y order."""
    rng = np.random.RandomState(4)
    rate = 44100
    x = rng.randn(int(1.0 * rate))
    pcm = np.clip(x / np.abs(x).max() * 15000, -32768,
                  32767).astype(np.int16)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                        sample_rate_hz=rate)
    out = encode_layer3_fast(pcm, cfg, "cpu")
    ours = decode_mp3(out)[0][:, 0] * 32768.0
    theirs, _ = mpg123.decode(out)
    theirs = theirs[:, 0].astype(np.float64)
    n = min(len(ours), len(theirs))
    e = ours[:n] - theirs[:n]
    agree = 10 * np.log10(max((ours[:n] ** 2).sum(), 1e-30)
                          / max((e ** 2).sum(), 1e-30))
    assert agree > 20.0, agree


def _crc_signal(seconds, nch, rate=44100):
    """tests/test_crc.py's tone with noise."""
    rng = np.random.RandomState(3)
    t = np.arange(int(seconds * rate)) / rate
    x = 0.25 * np.sin(2 * np.pi * 440 * t) + 0.03 * rng.randn(len(t))
    pcm = np.stack([x] * nch)
    return np.clip(pcm * 20000, -32768, 32767).astype(np.int16)


def _check_crc_frames(out, nch, kbps, rate):
    """Walk the CBR frame grid; recompute each frame's CRC-16 (ISO
    11172-3: poly 0x8005, init 0xffff, over header bits 16..31 and the
    side info) and compare it with the stored word."""
    fsize = (144000 * kbps) // rate
    si_bytes = (mpeg.sideinfo_bits(mpeg.MPEG1, nch, True) - 32 - 16) // 8
    nframes = 0
    for off in range(0, len(out) - fsize + 1, fsize):
        frame = out[off:off + fsize]
        assert frame[0] == 0xFF and (frame[1] & 0xF0) == 0xF0
        assert (frame[1] & 1) == 0, "protection bit must be 0 with -e"
        stored = (frame[4] << 8) | frame[5]
        crc = 0xFFFF
        for b in frame[2:4]:
            crc = _update_crc16(b, 8, crc)
        for b in frame[6:6 + si_bytes]:
            crc = _update_crc16(b, 8, crc)
        assert stored == crc, (off, hex(stored), hex(crc))
        nframes += 1
    assert nframes >= 5
    return nframes


@pytest.mark.parametrize("mode,nch", [(mpeg.MODE_MONO, 1),
                                      (mpeg.MODE_STEREO, 2)],
                         ids=["mono", "stereo"])
def test_fast_path_crc(mode, nch):
    pcm = _crc_signal(0.6, nch)
    cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=128 if nch == 2
                        else 64, sample_rate_hz=44100,
                        error_protection=True)
    out = encode_layer3_fast(pcm[0] if nch == 1 else pcm, cfg, "cpu")
    _check_crc_frames(out, nch, cfg.bitrate_kbps, 44100)
    dec, rate = decode_mp3(out)
    assert rate == 44100
    snr = float(snr_db(pcm[0].astype(np.float64), dec[:, 0]))
    assert snr > 5.0, snr
    theirs, rate = mpg123.decode(out)
    assert rate == 44100 and theirs.shape[1] == nch
    assert best_lag_snr(pcm[0], theirs[:, 0]) > 5.0


def _scfsi_count(out, nch, kbps, rate):
    data = np.frombuffer(out, np.uint8)
    fsize = 144000 * kbps // rate
    nset = frames = 0
    for off in range(0, len(data) - fsize + 1, fsize):
        br = BitReader(data[off:off + fsize])
        br.pos = 32
        si = _parse_side_info(br, nch)
        nset += sum(sum(si["scfsi"][ch]) for ch in range(nch))
        frames += 1
    return nset, frames


def test_scfsi_fires_on_stationary_tone():
    rate = 44100
    t = np.arange(int(0.8 * rate)) / rate
    pcm = np.clip(0.2 * np.sin(2 * np.pi * 440 * t) * 32767,
                  -32768, 32767).astype(np.int16)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=64,
                        sample_rate_hz=rate)
    out = encode_layer3_fast(pcm, cfg, "cpu", chunk=64)
    nset, frames = _scfsi_count(out, 1, 64, rate)
    assert frames >= 20
    assert nset >= frames, (nset, frames)  # fires broadly when stationary
    dec, drate = decode_mp3(out)
    assert drate == rate
    snr = float(snr_db(pcm.astype(np.float64), dec[:, 0]))
    assert snr > 40.0, snr
    theirs, drate = mpg123.decode(out)
    assert drate == rate
    assert best_lag_snr(pcm, theirs[:, 0]) > 40.0
