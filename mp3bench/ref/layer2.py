"""Plain reference for MPEG-1 Layer II streams (ISO/IEC 11172-3).

It judges a stream that the program made from PCM that the benchmark
made, with nothing of the program:

- ``structure``: the stream's length (whole frames on the CBR grid and
  one flush byte) and every frame's header against the configuration;
- ``parse_frame``: one frame's bit allocation, scfsi, scale factors and
  sample codes, its CRC recomputed over the protected fields
  (2.4.3.1), the ancillary bits that fill the frame (all zero), and
  whether the allocation is full: no subband below its table's top
  could take its next step in the bits left over, which a greedy
  allocation (C.1.5.2.7) guarantees whatever the masking;
- ``elements``: the scale factors, the scfsi and the sample codes that
  the frame's allocation implies for the PCM: the polyphase filterbank
  (C.1.3), the scale factor of each part (the smallest of Table B.1 at
  or above the part's peak), the ISO encoder's scfsi choice (C.1.5.2.5)
  and the quantizer a x + b with its sign bit (C.1.5.2.8), above the
  joint-stereo bound on (L + R) / 2 with its own scale factor, in
  float64 (or, for the control, in a lower precision).
"""
import numpy as np
import torch

from . import tables as T
from .bits import Bits, crc16

SBLIMIT = 32


def frame_bytes(cfg):
    return 144 * cfg["bitrate_kbps"] * 1000 // cfg["sample_rate_hz"]


def _header_fields(cfg):
    return dict(
        kbps=T.BITRATE_KBPS[(1, 2)].index(cfg["bitrate_kbps"]),
        rate=T.SAMPLE_RATE_INDEX[cfg["sample_rate_hz"]])


def structure(data, cfg, n_samples):
    """(number of frames, faults) of a Layer II stream: whole frames of
    ``frame_bytes`` and one zero flush byte; each header MPEG-1 Layer II
    at the configured bitrate and rate, CRC as configured, no padding,
    mode stereo or joint stereo for a joint-stereo configuration (the
    configured mode otherwise), mode_ext 0 outside joint stereo, no
    copyright, original or emphasis."""
    faults = []
    n_frames = -(-n_samples // 1152)
    size = frame_bytes(cfg)
    data = np.frombuffer(bytes(data), np.uint8)
    if len(data) != n_frames * size + 1 or data[-1] != 0:
        return n_frames, [f"stream of {len(data)} bytes, {n_frames} frames "
                          f"of {size} and a zero byte expected"]
    h = data[:-1].reshape(n_frames, size)[:, :4].astype(np.int64)
    w = h[:, 0] << 24 | h[:, 1] << 16 | h[:, 2] << 8 | h[:, 3]
    f = _header_fields(cfg)
    fixed = (0xFFF << 20) | (1 << 19) | (2 << 17) | \
        ((0 if cfg["crc"] else 1) << 16) | f["kbps"] << 12 | f["rate"] << 10
    mode = (w >> 6) & 3
    ext = (w >> 4) & 3
    want_mode = T.MODES[cfg["mode"]]
    ok = ((w & 0xFFFFFE00) == fixed) & ((w & 0x10F) == 0)
    if want_mode == T.MODES["joint_stereo"]:
        ok &= (mode == 1) | ((mode == 0) & (ext == 0))
    else:
        ok &= (mode == want_mode) & (ext == 0)
    for i in np.nonzero(~ok)[0][:5]:
        faults.append(f"frame {i}: header {int(w[i]):08x}")
    return n_frames, faults


def parse_frame(data, cfg, f):
    """Frame f's fields and faults: a dict with ba (2, 32), scfsi (2, 32),
    sf (2, 32, 3), codes (2, 3, 12, 32), jsbound, table, the frame's
    coded bits by kind, and ``faults`` (a list of strings)."""
    size = frame_bytes(cfg)
    raw = bytes(data[f * size:(f + 1) * size])
    b = Bits(raw)
    nch = 1 if cfg["mode"] == "mono" else 2
    hdr = b.get(32)
    mode, ext = (hdr >> 6) & 3, (hdr >> 4) & 3
    crc = b.get(16) if cfg["crc"] else None
    al = T.layer2_table(cfg["sample_rate_hz"], cfg["bitrate_kbps"], nch)
    sblimit = al["sblimit"]
    jsbound = T.JS_BOUND_L2[ext] if mode == 1 else sblimit
    faults = []
    ba = np.zeros((2, SBLIMIT), np.int64)
    alloc_bits = 0
    prot = [(hdr >> 12 & 0xF, 4), (hdr >> 10 & 3, 2), (hdr >> 9 & 1, 1),
            (hdr >> 8 & 1, 1), (mode, 2), (ext, 2), (hdr >> 3 & 1, 1),
            (hdr >> 2 & 1, 1), (hdr & 3, 2)]
    for sb in range(sblimit):
        for ch in range(nch if sb < jsbound else 1):
            nb = int(al["nbal"][sb])
            ba[ch, sb] = b.get(nb)
            alloc_bits += nb
            prot.append((int(ba[ch, sb]), nb))
            if ba[ch, sb] and al["steps"][sb, ba[ch, sb]] == 0:
                faults.append(f"frame {f}: allocation {ba[ch, sb]} in "
                              f"subband {sb}")
        if nch == 2 and sb >= jsbound:
            ba[1, sb] = ba[0, sb]
    if faults:
        return dict(faults=faults)
    scfsi = np.zeros((2, SBLIMIT), np.int64)
    for sb in range(sblimit):
        for ch in range(nch):
            if ba[ch, sb]:
                scfsi[ch, sb] = b.get(2)
                prot.append((int(scfsi[ch, sb]), 2))
    if cfg["crc"] and crc16(prot) != crc:
        faults.append(f"frame {f}: CRC {crc:04x}, {crc16(prot):04x} computed")
    sf = np.zeros((2, SBLIMIT, 3), np.int64)
    n_sf = 0
    for sb in range(sblimit):
        for ch in range(nch):
            if ba[ch, sb]:
                s = scfsi[ch, sb]
                if s == 0:
                    sf[ch, sb] = [b.get(6), b.get(6), b.get(6)]
                elif s == 1:
                    a, c = b.get(6), b.get(6)
                    sf[ch, sb] = [a, a, c]
                elif s == 3:
                    a, c = b.get(6), b.get(6)
                    sf[ch, sb] = [a, c, c]
                else:
                    sf[ch, sb] = b.get(6)
                n_sf += T.SFS_PER_SCFSI[s]
    if (sf == 63).any():
        faults.append(f"frame {f}: scale factor 63")
    codes = np.zeros((2, 3, 12, SBLIMIT), np.int64)
    sample_bits = 0
    for t in range(3):
        for j in range(0, 12, 3):
            for sb in range(sblimit):
                for ch in range(nch if sb < jsbound else 1):
                    a = int(ba[ch, sb])
                    if not a:
                        continue
                    steps, bits = int(al["steps"][sb, a]), int(al["bits"][sb, a])
                    if al["group"][sb, a] == 3:
                        c = [b.get(bits) for _ in range(3)]
                    else:
                        v = b.get(bits)
                        c = [v % steps, v // steps % steps,
                             v // steps // steps]
                        if v >= steps ** 3:
                            faults.append(f"frame {f}: group code {v}")
                    if max(c) >= steps:
                        faults.append(f"frame {f}: sample code {max(c)}")
                    codes[ch, t, j:j + 3, sb] = c
                    sample_bits += 3 * bits if al["group"][sb, a] == 3 \
                        else bits
                    if nch == 2 and sb >= jsbound:
                        codes[1, t, j:j + 3, sb] = c
    used = b.pos
    left = 8 * size - used
    if left < 0:
        faults.append(f"frame {f}: {used} bits in a frame of {8 * size}")
    elif b.get(left) != 0:
        faults.append(f"frame {f}: ancillary bits not zero")
    # a full allocation: no step below the top fits in what is left, at
    # the most it could cost (an unallocated subband's scfsi is not sent,
    # so it is priced at three scale factors)
    for sb in range(sblimit):
        for ch in range(nch if sb < jsbound else 1):
            a = int(ba[ch, sb])
            if a + 1 >= 1 << int(al["nbal"][sb]) or \
                    al["steps"][sb, a + 1] == 0:
                continue
            cost = 12 * al["group"][sb, a + 1] * al["bits"][sb, a + 1]
            if a:
                cost -= 12 * al["group"][sb, a] * al["bits"][sb, a]
            else:
                cost += (2 if nch == 2 and sb >= jsbound else 1) * (2 + 18)
            if cost <= left:
                faults.append(f"frame {f}: subband {sb} channel {ch} at "
                              f"step {a} could take {cost} of {left} "
                              f"bits left")
                break
    return dict(ba=ba, scfsi=scfsi, sf=sf, codes=codes, jsbound=jsbound,
                sblimit=sblimit, table=al, nch=nch, faults=faults,
                bits=dict(frame=8 * size, alloc=alloc_bits,
                          scfsi=2 * int((ba[:nch] > 0).sum()),
                          scalefactors=6 * n_sf, samples=sample_bits))


def subbands(pcm, frames, dtype=torch.float64):
    """(len(frames), 3, 12, 32) subband samples of one channel's int16
    PCM in the given frames, every product and sum in `dtype`."""
    fr = np.asarray(frames)
    t = 36 * fr[:, None] + np.arange(36)[None, :]              # shifts
    idx = 32 * t[..., None] + 31 - np.arange(512)[None, None, :]
    x = np.where((idx >= 0) & (idx < len(pcm)),
                 pcm[np.clip(idx, 0, len(pcm) - 1)], 0)
    x = torch.from_numpy(x / 32768.0).to(dtype)
    z = x * torch.from_numpy(T.ENWINDOW).to(dtype)
    y = z.reshape(*z.shape[:2], 8, 64).sum(2)
    s = y @ torch.from_numpy(T.ANALYSIS.T).to(dtype)
    return s.reshape(len(fr), 3, 12, 32)


def _scale_index(s):
    """Index of the smallest entry of Table B.1 at or above each part's
    peak: s (..., 12, 32) -> (..., 32)."""
    peak = s.abs().amax(-2).to(torch.float64).numpy()
    mult = T.MULTIPLE
    idx = np.searchsorted(-mult, -peak, side="right") - 1
    return np.clip(idx, 0, 62)


def _scfsi(scalar):
    """The ISO encoder's scfsi choice, C.1.5.2.5: scalar (3, 32) ->
    scfsi (32,) and the scale factors it sends, as the decoder expands
    them (3, 32)."""
    sc = scalar.copy()
    out = np.zeros(32, np.int64)

    def cls(d):
        return 0 if d <= -3 else 1 if d < 0 else 2 if d == 0 else \
            3 if d < 3 else 4

    for i in range(32):
        pat = T.SCFSI_PATTERN[cls(sc[0, i] - sc[1, i])][cls(sc[1, i] - sc[2, i])]
        if pat == 0x122:
            out[i], sc[2, i] = 3, sc[1, i]
        elif pat == 0x133:
            out[i], sc[1, i] = 3, sc[2, i]
        elif pat == 0x113:
            out[i], sc[1, i] = 1, sc[0, i]
        elif pat == 0x111:
            out[i] = 2
            sc[1, i] = sc[2, i] = sc[0, i]
        elif pat == 0x222:
            out[i] = 2
            sc[0, i] = sc[2, i] = sc[1, i]
        elif pat == 0x333:
            out[i] = 2
            sc[0, i] = sc[1, i] = sc[2, i]
        elif pat == 0x444:
            out[i] = 2
            sc[0, i] = min(sc[0, i], sc[2, i])
            sc[1, i] = sc[2, i] = sc[0, i]
    return out, sc


def _quantize(d, a, b, n, dtype):
    """C.1.5.2.8: v = a d + b; negative values move up by 1 and lose the
    top bit; the n-bit fraction truncated."""
    d = d.to(dtype) * a + b
    neg = d < 0
    d = torch.where(neg, d + 1, d)
    v = torch.floor(d * 2.0 ** n).to(torch.int64)
    return torch.where(neg, v, v | (1 << n))


def elements(sb, parsed, dtype=torch.float64):
    """The scfsi, scale factors and sample codes that `parsed`'s
    allocation implies for the subband samples `sb` (nch, 3, 12, 32) of
    the frame.  Returns (scfsi (2, 32), sf (2, 32, 3), codes (2, 3, 12,
    32)) over the allocated subbands (zeros elsewhere)."""
    nch, ba, al = parsed["nch"], parsed["ba"], parsed["table"]
    js = parsed["jsbound"]
    scfsi = np.zeros((2, 32), np.int64)
    sf = np.zeros((2, 32, 3), np.int64)
    codes = np.zeros((2, 3, 12, 32), np.int64)
    sent = []
    for ch in range(nch):
        s, sc = _scfsi(_scale_index(sb[ch]))
        scfsi[ch], sf[ch] = s, sc.T
        sent.append(sc)
    if nch == 2 and js < 32:
        jsample = (0.5 * (sb[0].to(dtype) + sb[1].to(dtype)))
        jscale = _scale_index(jsample)
    for sb_i in range(parsed["sblimit"]):
        for ch in range(nch if sb_i < js else 1):
            a = int(ba[ch, sb_i])
            if not a:
                continue
            steps, q = int(al["steps"][sb_i, a]), int(al["quant"][sb_i, a])
            n = (steps - 1).bit_length() - 1
            if nch == 2 and sb_i >= js:
                x, scale = jsample[:, :, sb_i], jscale[:, sb_i]
            else:
                x, scale = sb[ch][:, :, sb_i], sent[ch][:, sb_i]
            mult = torch.from_numpy(T.MULTIPLE[scale]).to(dtype)[:, None]
            c = _quantize(x.to(dtype) / mult, T.QUANT_A[q], T.QUANT_B[q], n,
                          dtype)
            codes[ch, :, :, sb_i] = c.numpy()
            if nch == 2 and sb_i >= js:
                codes[1, :, :, sb_i] = c.numpy()
    return scfsi, sf, codes


def coded_bits(data, cfg):
    """Each frame's coded fields by kind, from the frame layout alone
    (2.4.1.6), for every frame of the stream at once: {"frame", "alloc",
    "scfsi", "scalefactors", "samples"} -> (F,) bits."""
    size = frame_bytes(cfg)
    nch = 1 if cfg["mode"] == "mono" else 2
    al = T.layer2_table(cfg["sample_rate_hz"], cfg["bitrate_kbps"], nch)
    sblimit, nbal = al["sblimit"], al["nbal"]
    raw = np.frombuffer(bytes(data), np.uint8)
    F = len(raw) // size
    bits = np.unpackbits(raw[:F * size].reshape(F, size), axis=1) \
        .astype(np.int64)
    hdr = 32 + (16 if cfg["crc"] else 0)

    def field(pos, width):
        """(F,) values of `width` bits at per-frame bit positions pos."""
        v = np.zeros(F, np.int64)
        for k in range(int(width)):
            v = (v << 1) | bits[np.arange(F), pos + k]
        return v

    mode = field(np.full(F, 24), 2)
    ext = field(np.full(F, 26), 2)
    js = np.where(mode == 1, np.array(T.JS_BOUND_L2)[ext], sblimit)
    ba = np.zeros((F, 2, 32), np.int64)
    alloc = np.zeros(F, np.int64)
    for j in np.unique(js):
        rows = np.nonzero(js == j)[0]
        pos = hdr
        for sb in range(sblimit):
            for ch in range(nch if sb < j else 1):
                v = np.zeros(len(rows), np.int64)
                for k in range(int(nbal[sb])):
                    v = (v << 1) | bits[rows, pos + k]
                ba[rows, ch, sb] = v
                if nch == 2 and sb >= j:
                    ba[rows, 1, sb] = v
                pos += int(nbal[sb])
        alloc[rows] = pos - hdr
    on = (ba[:, :nch, :sblimit] > 0).transpose(0, 2, 1).reshape(F, -1)
    start = hdr + alloc
    pos = start[:, None] + 2 * (np.cumsum(on, 1) - on)
    scfsi = (bits[np.arange(F)[:, None], pos] << 1) | \
        bits[np.arange(F)[:, None], pos + 1]
    sfs = np.array(T.SFS_PER_SCFSI)[scfsi] * on
    b_ = np.take_along_axis(al["bits"][None, :sblimit, :].repeat(F, 0),
                            ba[:, 0, :sblimit, None], 2)[..., 0]
    g_ = np.take_along_axis(al["group"][None, :sblimit, :].repeat(F, 0),
                            ba[:, 0, :sblimit, None], 2)[..., 0]
    per_sb = 12 * b_ * g_ * (ba[:, 0, :sblimit] > 0)
    samples = per_sb.sum(1)
    if nch == 2:
        b1 = np.take_along_axis(al["bits"][None, :sblimit, :].repeat(F, 0),
                                ba[:, 1, :sblimit, None], 2)[..., 0]
        g1 = np.take_along_axis(al["group"][None, :sblimit, :].repeat(F, 0),
                                ba[:, 1, :sblimit, None], 2)[..., 0]
        own = np.arange(sblimit)[None, :] < js[:, None]
        samples += (12 * b1 * g1 * (ba[:, 1, :sblimit] > 0) * own).sum(1)
    return {"frame": np.full(F, 8 * size), "alloc": alloc,
            "scfsi": 2 * on.sum(1), "scalefactors": 6 * sfs.sum(1),
            "samples": samples}
