"""The plain reference: its filterbank and MDCT against the ISO
encoder's float64 formulation kept in the port's numpy_ref (a test may
read both; the reference imports nothing of the port), its CRC, its
MPEG-2 LSF tables against the port's copies, a stream of the port on
the CPU judged whole (no fault, no mismatch) in MPEG-1 and at each LSF
rate, and a stored MPEG-1 stream judged as the reference judged it
before it learnt LSF."""
import hashlib
import os

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


def lsf(rate, kbps, mode="stereo"):
    """An MPEG-2 LSF Layer III configuration: `rate` is 16, 22.05 or 24
    kHz; whole slots, no padding slot, as ``L3``."""
    return dict(L3, sample_rate_hz=rate, bitrate_kbps=kbps, mode=mode,
                channels=1 if mode == "mono" else 2)


#: where the port's LSF tables depart from 13818-3's, (rate, table,
#: index): (port's value, the standard's).  At 24 kHz the port keeps the
#: ISO reference software's long band edge 330; the standard's Table
#: B.2 gives 332 (bands 17 and 18 of 54 and 62 lines)
PORT_DEPARTS = {(24000, "long", 18): (330, 332)}


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


@pytest.mark.parametrize("layer", [
    3, 2, pytest.param(lsf(24000, 64), id="lsf-24k-64k"),
    pytest.param(lsf(22050, 56), id="lsf-22k-56k"),
    pytest.param(lsf(16000, 32), id="lsf-16k-32k"),
    pytest.param(lsf(24000, 32, "mono"), id="lsf-24k-32k-mono")])
def test_a_port_stream_is_judged_sound(layer):
    """MPEG-1 Layer III and II, and Layer III at each LSF rate (22.05 kHz
    at 56 kbps: 182.86 slots a frame, whole slots and no padding slot as
    the configuration's ``padding`` says)."""
    from mp3bench.entries import encoder_config
    from mp3tpu_torch.encoder import encode_layer12_fast, encode_layer3_fast
    cfg = layer if isinstance(layer, dict) else {3: L3, 2: L2}[layer]
    nch = cfg.get("channels", 2)
    pcm = programme(2 ** 31 + 3, 3.0, cfg["sample_rate_hz"], CPU, nch=nch)
    enc = encode_layer12_fast if cfg["layer"] == 2 else encode_layer3_fast
    out = enc(pcm, encoder_config(cfg), "cpu")
    r = check.judge(cfg, [(pcm, out)], 20, 1)
    assert r["bad_frames"] == 0 and r["faults"] == []
    assert r["compared"] > 10000 and r["mismatch_ppm"] == 0.0
    c = check.judge(cfg, [(pcm, out)], 20, 1, control=True)
    assert c["mismatch_ppm"] > 1000
    if cfg["layer"] == 3:
        assert 0 < r["short"] < r["granules"]
        assert r["unspent_pct"] < 7 and r["silenced_pct"] == 0


def test_lsf_tables_equal_the_ports():
    """The reference's LSF band edges and nr_of_sfb partitions, written
    from 13818-3, equal the port's copies in ``tables/mpeg.py`` but
    where ``PORT_DEPARTS`` says; the MPEG-1 edges equal them too."""
    from mp3bench.ref import tables as T
    from mp3tpu_torch.tables import mpeg
    found = {}
    for rate, idx in list(T.LSF_SAMPLE_RATE_INDEX.items()) + list(
            T.SAMPLE_RATE_INDEX.items()):
        version = mpeg.MPEG2_LSF if rate in T.LSF_SAMPLE_RATE_INDEX \
            else mpeg.MPEG1
        assert mpeg.S_FREQ_KHZ[version][idx] * 1000 == rate
        for name, ref, port in (
                ("long", T.SFB_LONG[rate], mpeg.sfb_long(version, idx)),
                ("short", T.SFB_SHORT[rate], mpeg.sfb_short(version, idx))):
            assert len(ref) == len(port)
            for i, (a, b) in enumerate(zip(port.tolist(), ref)):
                if a != b:
                    found[(rate, name, i)] = (a, b)
    assert set(found) <= set(PORT_DEPARTS)
    assert all(found[k] == PORT_DEPARTS[k] for k in found)
    assert np.array_equal(np.array(T.NR_OF_SFB), mpeg.NR_OF_SFB_BLOCK)
    assert np.array_equal(T.PRETAB[:21], mpeg.PRETAB)
    lsf_row = mpeg.BITRATE_KBPS[mpeg.MPEG2_LSF][2].tolist()
    assert T.BITRATE_KBPS[(0, 3)] == lsf_row


def test_lsf_tables_hold_the_standards_shape():
    """Each LSF table runs from 0 to 576 (long) or 192 (short) lines,
    rising; each nr_of_sfb row covers 21 long bands, 12 short bands a
    window each, or (mixed) 6 long bands and short bands 3-11 a window
    each."""
    from mp3bench.ref import tables as T
    for rate in T.LSF_SAMPLE_RATE_INDEX:
        for edges, top, n in ((T.SFB_LONG[rate], 576, 23),
                              (T.SFB_SHORT[rate], 192, 14)):
            assert len(edges) == n and edges[0] == 0 and edges[-1] == top
            assert all(b > a for a, b in zip(edges, edges[1:]))
    for long_, short, mixed in T.NR_OF_SFB:
        assert sum(long_) == 21 and sum(short) == 36
        assert sum(mixed) == 6 + 27


def test_lsf_slen_decodes_every_scalefac_compress():
    """13818-3 2.4.3.2: every 9-bit scalefac_compress gives widths the
    standard allows, table 0 below 400, 1 to 499, 2 (preflag) above;
    the port's encoder codes tables 0 and 2 by the inverse formulas."""
    from mp3bench.ref.layer3 import lsf_slen
    seen = {}
    for sc in range(512):
        slen, table = lsf_slen(sc)
        assert table == (0 if sc < 400 else 1 if sc < 500 else 2)
        assert all(0 <= w <= 4 for w in slen)
        seen.setdefault(table, set()).add(tuple(slen))
    assert len(seen[0]) == 400 and len(seen[1]) == 100 and len(seen[2]) == 12
    for s1 in range(5):
        for s2 in range(5):
            for s3 in range(4):
                for s4 in range(4):
                    sc = ((s1 * 5 + s2) << 4) + (s3 << 2) + s4
                    assert lsf_slen(sc) == ([s1, s2, s3, s4], 0)
    for s1 in range(4):
        for s2 in range(3):
            assert lsf_slen(500 + 3 * s1 + s2) == ([s1, s2, 0, 0], 2)


def test_the_24k_band_edge_is_the_only_lsf_mismatch():
    """At 24 kHz and 96 kbps the port's streams mismatch the standard's
    quantizer on lines 330 and 331 of long blocks alone: the lines that
    the port's band edge 330 gives band 18's scale factor, where the
    standard's 332 gives them band 17's (``PORT_DEPARTS``)."""
    from mp3bench.entries import encoder_config
    from mp3tpu_torch.encoder import encode_layer3_fast
    cfg = lsf(24000, 96)
    pcm = programme(2 ** 31 + 3, 3.0, 24000, CPU, noise=0.1)
    out = encode_layer3_fast(pcm, encoder_config(cfg), "cpu")
    frames, faults = R3.structure(out, cfg, pcm.shape[1])
    assert not faults
    lines = set()
    for f in range(len(frames)):
        for g in R3.decode_frame(out, frames, f, 24000):
            xr = R3.analysis(pcm[g[1]], [g[0]], [g[2]["block_type"]])
            want = R3.requantize(xr, [g], 24000)[0]
            lines |= {(g[2]["block_type"] == R3.SHORT, int(i))
                      for i in np.nonzero(np.abs(g[5]) != want)[0]}
    assert lines <= {(False, 330), (False, 331)}


#: the stored stream: the port's, 2 s of ``programme(2 ** 31 + 5)`` at
#: 44.1 kHz, 128 kbps, stereo
STORED = os.path.join(os.path.dirname(__file__), "data", "l3-cd-128k.mp3")
GI_KEYS = ("part2_3_length", "big_values", "global_gain",
           "scalefac_compress", "window_switching", "block_type", "mixed",
           "table_select", "subblock_gain", "region0_count", "region1_count",
           "preflag", "scalefac_scale", "count1table_select")
#: the reference's readings of the stored stream before it learnt LSF:
#: its frames and every granule decoded (digest), and ``judge`` of the
#: stream, of its control and of the stream with a bit of every frame
#: flipped, every frame in depth, seed 7
BEFORE = dict(
    frames=77,
    digest="1806e58cf38f2bc82e46ca86bc6bb7c8d7cba40e2503ee3b98dadde434da055b",
    sound=dict(bad_frames=0, compared=177408, mismatched=0, granules=308,
               short=19, faults=[], silenced_pct=0.0,
               unspent_pct=0.7976275692811126, mismatch_ppm=0.0),
    control=dict(bad_frames=0, compared=177408, mismatched=1574,
                 granules=308, short=19, faults=[], silenced_pct=0.0,
                 unspent_pct=0.7976275692811126,
                 mismatch_ppm=8872.204184704186),
    flipped=dict(bad_frames=17, compared=138240, mismatched=2134,
                 granules=308, short=19, faults=[
                     "frame 1: big values run past part2_3_length",
                     "frame 8: count1 quads past line 576",
                     "frame 19: count1 quads past line 576",
                     "frame 20: count1 quads past line 576",
                     "frame 23: count1 quads past line 576"],
                 silenced_pct=2.0833333333333335,
                 unspent_pct=0.7976275692811126,
                 mismatch_ppm=15436.921296296296))


def test_mpeg1_judged_as_before_lsf():
    """The MPEG-1 path reads what it read before LSF came in: the same
    frames, side info, scale factors and lines, the same faults and the
    same numbers, to the last digit."""
    stream = open(STORED, "rb").read()
    pcm = programme(2 ** 31 + 5, 2.0, 44100, CPU)
    frames, faults = R3.structure(stream, L3, pcm.shape[1])
    assert (len(frames), faults) == (BEFORE["frames"], [])
    h = hashlib.sha256()
    for f, fr in enumerate(frames):
        h.update(repr([fr[k] for k in ("offset", "size", "md_start",
                                       "md_bits", "own", "md_offset",
                                       "hdr")]).encode())
        si = fr["si"]
        h.update(repr((si["main_data_begin"], si["scfsi"],
                       [[[gi[k] for k in GI_KEYS] for gi in gr]
                        for gr in si["gr"]])).encode())
        for g in R3.decode_frame(stream, frames, f, 44100):
            h.update(repr((g[0], g[1], g[3].tolist(), g[4].tolist(),
                           g[5].tolist())).encode())
    assert h.hexdigest() == BEFORE["digest"]
    flipped = bytearray(stream)
    for o in range(0, len(flipped) - 1 - 96, 417):
        flipped[o + 96] ^= 0x10
    for name, data, control in (("sound", stream, False),
                                ("control", stream, True),
                                ("flipped", bytes(flipped), False)):
        got = check.judge(L3, [(pcm, data)], 10 ** 6, 7, control=control)
        assert got == BEFORE[name], name
