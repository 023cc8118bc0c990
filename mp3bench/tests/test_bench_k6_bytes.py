"""K6's bytes, counted from the Layer II frame layout: one 48 kHz joint
stereo 192 kbit/s frame built here field by field and worked out by
hand."""
import numpy as np

from mp3bench.ref import layer2 as R2
from mp3bench.ref.bits import crc16

CFG = dict(layer=2, mode="joint_stereo", channels=2, bitrate_kbps=192,
           sample_rate_hz=48000, crc=True)


class Writer:
    def __init__(self):
        self.fields = []

    def put(self, v, n):
        self.fields.append((int(v), int(n)))

    def bits(self):
        return "".join(format(v, f"0{n}b") if n else ""
                       for v, n in self.fields)


def frame():
    """Table B.2a (sblimit 27: 4-bit allocations in subbands 0-10, 3-bit
    in 11-22, 2-bit in 23-26); joint stereo with mode_ext 1, so the
    bound is subband 8.  Allocated: subband 0 of channel 0 at index 2 (7
    steps, 3-bit codes, not grouped), subband 0 of channel 1 at index 1
    (3 steps, grouped in 5 bits), joint subband 12 at index 4 (9 steps,
    grouped in 10 bits)."""
    hdr = Writer()
    for v, n in ((0xFFF, 12), (1, 1), (2, 2), (0, 1), (10, 4), (1, 2),
                 (0, 1), (0, 1), (1, 2), (1, 2), (0, 1), (0, 1), (0, 2)):
        hdr.put(v, n)
    ba = {(0, 0): 2, (1, 0): 1, (0, 12): 4}
    body = Writer()
    nbal = [4] * 11 + [3] * 12 + [2] * 4
    for sb in range(27):
        for ch in range(2 if sb < 8 else 1):
            body.put(ba.get((ch, sb), 0), nbal[sb])
    scfsi = {(0, 0): 0, (1, 0): 2, (0, 12): 1, (1, 12): 3}
    for sb in (0, 12):
        for ch in (0, 1):
            body.put(scfsi[(ch, sb)], 2)
    prot = [(v, n) for v, n in hdr.fields[4:]] + body.fields
    for sb in (0, 12):
        for ch in (0, 1):
            for _ in range({0: 3, 1: 2, 2: 1, 3: 2}[scfsi[(ch, sb)]]):
                body.put(20 + sb, 6)
    for t in range(3):
        for j in range(4):
            for _ in range(3):
                body.put(5, 3)                     # ch 0, subband 0
            body.put(1 + 3 * 2 + 9 * 0, 5)         # ch 1, subband 0
            body.put(4 + 9 * 8 + 81 * 0, 10)       # joint subband 12
    crc = crc16(prot)
    bits = hdr.bits() + format(crc, "016b") + body.bits()
    bits += "0" * (576 * 8 - len(bits))
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)) \
        + b"\x00"


def test_counts_worked_by_hand():
    s = frame()
    b = R2.coded_bits(s, CFG)
    # allocation: 8 subbands x 2 channels x 4 bits + 3 x 4 (joint, 4-bit)
    # + 12 x 3 + 4 x 2 = 64 + 12 + 36 + 8
    assert b["alloc"].tolist() == [120]
    # scfsi: 2 bits for each of 4 allocated (channel, subband)
    assert b["scfsi"].tolist() == [8]
    # scale factors: scfsi 0, 2, 1, 3 send 3, 1, 2, 2 of 6 bits
    assert b["scalefactors"].tolist() == [48]
    # samples: 36 x 3 (ungrouped) + 12 x 5 + 12 x 10 (grouped, joint once)
    assert b["samples"].tolist() == [108 + 60 + 120]
    assert b["frame"].tolist() == [4608]


def test_k6_bytes_and_the_parser_agree():
    from mp3bench.harness import load_file
    s = frame()
    k6 = load_file("metrics", "k6_roofline")
    # 576 bytes written, (120 + 8 + 48 + 288) / 8 = 58 read
    assert k6.k6_bytes([s], CFG) == 576 + 58
    p = R2.parse_frame(np.frombuffer(s, np.uint8), CFG, 0)
    assert p["bits"] == dict(frame=4608, alloc=120, scfsi=8,
                             scalefactors=48, samples=288)
    assert p["jsbound"] == 8 and p["ba"][1, 12] == 4
    assert [f for f in p["faults"] if "CRC" in f or "ancillary" in f] == []
