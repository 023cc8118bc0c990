"""The plain reference: its filterbank and MDCT against the ISO
encoder's float64 formulation kept in the port's numpy_ref (a test may
read both; the reference imports nothing of the port), its CRC, and a
stream of the port on the CPU judged whole: no fault, no mismatch."""
import numpy as np
import pytest
import torch

from mp3bench import check
from mp3bench.ref import layer2 as R2
from mp3bench.ref import layer3 as R3
from mp3bench.ref.bits import Bits, crc16
from mp3bench.signals import programme

CPU = torch.device("cpu")
L3 = dict(layer=3, mode="stereo", channels=2, bitrate_kbps=128,
          sample_rate_hz=44100, crc=False, psy_model=2, padding=False)
L2 = dict(layer=2, mode="joint_stereo", channels=2, bitrate_kbps=192,
          sample_rate_hz=48000, crc=True, psy_model=2)


def test_analysis_equals_the_iso_formulation():
    from mp3tpu_torch.numpy_ref import dsp
    pcm = programme(5, 0.6, 44100, CPU)[0]
    G = 40
    bt = np.zeros(G, int)
    bt[10:13] = [1, 2, 3]
    want = dsp.mdct_granules(dsp.granule_subbands(pcm[:576 * G] / 32768.0,
                                                  G), bt)
    got = R3.analysis(pcm, np.arange(G), bt).numpy()
    assert np.abs(got - want).max() < 1e-12
    sb = R2.subbands(pcm, [0, 3]).numpy()
    s = dsp.subband_filter_stream(pcm / 32768.0, 36 * 4).reshape(4, 3, 12,
                                                                 32)
    assert np.abs(sb - s[[0, 3]]).max() < 1e-12


def test_crc_and_bits():
    from mp3tpu_torch.numpy_ref.layer12 import _update_crc
    fields = [(0xA, 4), (1, 2), (0, 1), (5, 3), (0x3F, 6), (2, 2)]
    crc = 0xFFFF
    for v, n in fields:
        crc = _update_crc(v, n, crc)
    assert crc16(fields) == crc
    b = Bits(bytes([0b10110011, 0xFF, 0x00, 0x5A]) + bytes(8))
    assert b.get(3) == 0b101 and b.get(13) == 0b1001111111111
    assert b.peek(8) == 0 and b.get(40) == 0x5A << 24


@pytest.mark.parametrize("layer", [3, 2])
def test_a_port_stream_is_judged_sound(layer):
    from mp3bench.entries import encoder_config
    from mp3tpu_torch.encoder import encode_layer12_fast, encode_layer3_fast
    cfg = L3 if layer == 3 else L2
    pcm = programme(2 ** 31 + 3, 3.0, cfg["sample_rate_hz"], CPU)
    enc = encode_layer3_fast if layer == 3 else encode_layer12_fast
    out = enc(pcm, encoder_config(cfg), "cpu")
    r = check.judge(cfg, [(pcm, out)], 20, 1)
    assert r["bad_frames"] == 0 and r["faults"] == []
    assert r["compared"] > 10000 and r["mismatch_ppm"] == 0.0
    c = check.judge(cfg, [(pcm, out)], 20, 1, control=True)
    assert c["mismatch_ppm"] > 1000
    if layer == 3:
        assert 0 < r["short"] < r["granules"]
