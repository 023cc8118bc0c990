"""Plain reference for Layer III streams: MPEG-1 (ISO/IEC 11172-3) and
MPEG-2 at the lower sampling frequencies, 16, 22.05 and 24 kHz (LSF,
ISO/IEC 13818-3).

It judges a stream that the program made from PCM that the benchmark
made, with nothing of the program:

- ``structure``: every frame's header against the configuration, the
  frame count and sizes, the side info's ranges, the window sequence
  (each granule's window must overlap-add with the next one's), and the
  bit reservoir (each frame's main data begins inside the reservoir,
  no further back than main_data_begin's width allows, after the
  previous frame's, and ends inside its own frame);
- ``decode_frame``: the scale factors and Huffman codes of one frame,
  which must fill each granule's part2_3_length exactly;
- ``analysis`` and ``requantize``: the polyphase filterbank and the MDCT
  of the PCM under the stream's block types, and the quantizer
  ix = nint((|xr| 2^(a sf) / 2^((gg - 210 - 8 sbg) / 4))^0.75 - 0.0946)
  under the stream's gains and scale factors, in float64 (or, for the
  control, in a lower precision).  A line whose quantized value differs
  from the stream's is a mismatch;
- ``dequantize``: the lines that a decoder reads from the stream,
  |ix|^(4/3) 2^-e with ix's sign, which ``analysis`` of the PCM
  measures the stream's noise against.

The version follows from the sample rate, as the header's ID bit does.
An LSF frame (13818-3 2.4.1.7, 2.4.2.7, 2.4.3.2) holds one granule of
576 samples, 72 kbps / rate slots; its side info has an 8-bit
main_data_begin (a reservoir of at most 255 bytes), no scfsi and a
9-bit scalefac_compress that gives four scale factor widths, their
partition of the bands and preflag.  Intensity stereo, which LSF codes
in scalefac_compress too, is outside the reference: a stream that sets
mode_extension is refused by its header.
"""
import numpy as np
import torch

from . import tables as T
from .bits import PEEK, Bits

NORM, START, SHORT, STOP = 0, 1, 2, 3
# the first and second half of each window: long (0) or short (1) shaped
_HEAD = {NORM: 0, START: 0, SHORT: 1, STOP: 1}
_TAIL = {NORM: 0, START: 1, SHORT: 1, STOP: 0}


def _lookup(t):
    """Table t's codes as a PEEK-bit lookup: prefix -> (x, y, length)."""
    hlen, codes = T.HUFF_HLEN[t], T.HUFF_CODES[t]
    n = 16 if t >= 32 else int(T.HUFF_XLEN[t])
    lut = np.zeros(1 << PEEK, np.int64)
    for x in range(1 if t >= 32 else n):
        for y in range(16 if t >= 32 else n):
            ln = int(hlen[x, y])
            if ln == 0:
                continue
            lo = int(codes[x, y]) << (PEEK - ln)
            lut[lo: lo + (1 << (PEEK - ln))] = (x << 16) | (y << 8) | ln
    return lut


_LUTS = {}


def _lut(t):
    if t not in _LUTS:
        _LUTS[t] = _lookup(t)
    return _LUTS[t]


def granules(rate_hz):
    """Granules a frame: 2 in MPEG-1, 1 in LSF (13818-3 2.4.1.7)."""
    return 1 if rate_hz in T.LSF_SAMPLE_RATE_INDEX else 2


def frame_sizes(n_frames, kbps, rate_hz, padded):
    """Bytes of each frame: 72 kbps / rate slots a granule (144 in
    MPEG-1, 72 in LSF), plus the padding slot where the true-CBR schedule
    (2.4.3.1) or nothing (`padded` False) asks for one."""
    exact = 72000.0 * granules(rate_hz) * kbps / rate_hz
    whole = int(exact)
    if not padded or exact == whole:
        return np.full(n_frames, whole, np.int64)
    frac = exact - whole
    pad = np.zeros(n_frames, np.int64)
    lag = -frac
    for i in range(n_frames):
        if lag > frac - 1.0:
            lag -= frac
        else:
            pad[i] = 1
            lag += 1 - frac
    return whole + pad


def _header_word(cfg, padding):
    rate = cfg["sample_rate_hz"]
    mpeg1 = granules(rate) == 2
    kbps_idx = T.BITRATE_KBPS[(int(mpeg1), 3)].index(cfg["bitrate_kbps"])
    w = (0xFFF << 20) | (int(mpeg1) << 19) | (1 << 17)     # ID, Layer III
    w |= (0 if cfg["crc"] else 1) << 16
    rates = T.SAMPLE_RATE_INDEX if mpeg1 else T.LSF_SAMPLE_RATE_INDEX
    w |= kbps_idx << 12 | rates[rate] << 10
    w |= padding << 9 | T.MODES[cfg["mode"]] << 6
    return w


def side_info(b, nch, ngr=2):
    """Side info at ``b.pos``: MPEG-1's (`ngr` 2) or LSF's (`ngr` 1: an
    8-bit main_data_begin, nch private bits, no scfsi (read as all 0),
    a 9-bit scalefac_compress and no preflag bit, preflag being
    scalefac_compress >= 500)."""
    lsf = ngr == 1
    si = dict(main_data_begin=b.get(8 if lsf else 9))
    if lsf:
        b.get(nch)
        si["scfsi"] = [[0] * 4 for _ in range(nch)]
    else:
        b.get(3 if nch == 2 else 5)
        si["scfsi"] = [[b.get(1) for _ in range(4)] for _ in range(nch)]
    gr = []
    for _ in range(ngr):
        chs = []
        for _ in range(nch):
            gi = dict(part2_3_length=b.get(12), big_values=b.get(9),
                      global_gain=b.get(8),
                      scalefac_compress=b.get(9 if lsf else 4),
                      window_switching=b.get(1))
            if gi["window_switching"]:
                gi.update(block_type=b.get(2), mixed=b.get(1),
                          table_select=[b.get(5), b.get(5), 0],
                          subblock_gain=[b.get(3) for _ in range(3)],
                          region0_count=7, region1_count=13)
            else:
                gi.update(block_type=NORM, mixed=0,
                          table_select=[b.get(5), b.get(5), b.get(5)],
                          subblock_gain=[0, 0, 0],
                          region0_count=b.get(4), region1_count=b.get(3))
            gi.update(preflag=int(gi["scalefac_compress"] >= 500) if lsf
                      else b.get(1), scalefac_scale=b.get(1),
                      count1table_select=b.get(1))
            chs.append(gi)
        gr.append(chs)
    si["gr"] = gr
    return si


def structure(data, cfg, n_samples, padded=False):
    """The stream's frames and its structural faults.

    Returns (frames, faults): frames is a list of dicts (offset, size,
    side info, main data start and end in the stream's main data bytes),
    faults a list of strings, one a fault found."""
    faults = []
    nch = 1 if cfg["mode"] == "mono" else 2
    ngr = granules(cfg["sample_rate_hz"])
    n_frames = -(-n_samples // (576 * ngr))
    sizes = frame_sizes(n_frames, cfg["bitrate_kbps"], cfg["sample_rate_hz"],
                        padded)
    data = np.frombuffer(bytes(data), np.uint8)
    if len(data) != int(sizes.sum()) + 1 or data[-1] != 0:
        faults.append(f"stream of {len(data)} bytes, {n_frames} frames of "
                      f"{int(sizes.sum())} and a zero byte expected")
        return [], faults
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    words = (data[offs].astype(np.int64) << 24 | data[offs + 1].astype(
        np.int64) << 16 | data[offs + 2].astype(np.int64) << 8
        | data[offs + 3].astype(np.int64))
    pad = sizes - sizes.min() if padded else np.zeros(n_frames, np.int64)
    want = np.array([_header_word(cfg, int(p)) for p in pad], np.int64)
    # the private bit (bit 8) is free; mode_ext (bits 4-5) must be 0 in
    # stereo; copyright, original and emphasis are 0
    bad = np.nonzero((words & ~0x100) != want)[0]
    for f in bad[:5]:
        faults.append(f"frame {f}: header {int(words[f]):08x}, "
                      f"{int(want[f]):08x} expected")
    if len(bad):
        return [], faults
    side_len = (32 if nch == 2 else 17) if ngr == 2 else \
        (17 if nch == 2 else 9)
    hdr = 6 if cfg["crc"] else 4
    frames, md_total, prev_end = [], 0, 0
    last = [None] * nch
    for f in range(n_frames):
        o = int(offs[f])
        si = side_info(Bits(data[o + hdr: o + hdr + side_len]), nch, ngr)
        own = int(sizes[f]) - hdr - side_len
        start = md_total - si["main_data_begin"]
        bits = 0
        for g in range(ngr):
            for ch in range(nch):
                gi = si["gr"][g][ch]
                bits += gi["part2_3_length"]
                if gi["big_values"] > 288:
                    faults.append(f"frame {f}: big_values {gi['big_values']}")
                if gi["window_switching"] and gi["block_type"] == NORM:
                    faults.append(f"frame {f}: window switching with "
                                  f"block type 0")
                if gi["mixed"]:
                    faults.append(f"frame {f}: mixed block")
                bt = gi["block_type"]
                if last[ch] is not None and _TAIL[last[ch]] != _HEAD[bt]:
                    faults.append(f"frame {f} granule {g} channel {ch}: "
                                  f"block type {bt} after {last[ch]}")
                last[ch] = bt
        end = start * 8 + bits
        if start < prev_end:
            faults.append(f"frame {f}: main data begins {start} before the "
                          f"previous frame's end {prev_end}")
        if end > (md_total + own) * 8:
            faults.append(f"frame {f}: main data ends at bit {end}, past its "
                          f"frame's end {(md_total + own) * 8}")
        frames.append(dict(offset=o, size=int(sizes[f]), si=si,
                           md_start=start, md_bits=bits, own=own,
                           md_offset=md_total, hdr=hdr + side_len))
        prev_end = -(-end // 8)
        md_total += own
    return frames, faults


def _main_data(data, frames, f):
    """Bytes of the main data from frame f's start to its frame's end."""
    data = np.frombuffer(bytes(data), np.uint8)
    out, need = [], frames[f]["md_start"]
    for fr in frames[:f + 1]:
        a, b = fr["md_offset"], fr["md_offset"] + fr["own"]
        if b <= need:
            continue
        lo = fr["offset"] + fr["hdr"] + max(0, need - a)
        out.append(data[lo: fr["offset"] + fr["size"]])
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def lsf_slen(scalefac_compress):
    """(slen1..slen4, table) of an LSF scalefac_compress in a channel
    without intensity stereo (13818-3 2.4.3.2): tables 0 (below 400),
    1 (400-499) and 2 (500 and above, which implies preflag)."""
    sc = scalefac_compress
    if sc < 400:
        return [(sc >> 4) // 5, (sc >> 4) % 5, (sc & 15) >> 2, sc & 3], 0
    if sc < 500:
        sc -= 400
        return [(sc >> 2) // 5, (sc >> 2) % 5, sc & 3, 0], 1
    sc -= 500
    return [sc // 3, sc % 3, 0, 0], 2


def _scalefacs_lsf(b, gi):
    """An LSF granule's scale factors: partition i holds nr_of_sfb[i]
    factors of slen_i bits, long bands 0-20 in order, or short bands
    0-11 a window each (band-major)."""
    slen, table = lsf_slen(gi["scalefac_compress"])
    short = gi["block_type"] == SHORT
    nr = T.NR_OF_SFB[table][1 if short else 0]
    vals = np.array([b.get(w) for w, n in zip(slen, nr) for _ in range(n)],
                    np.int64)
    sf_l = np.zeros(22, np.int64)
    sf_s = np.zeros((13, 3), np.int64)
    if short:
        sf_s[:12] = vals.reshape(12, 3)
    else:
        sf_l[:21] = vals
    return sf_l, sf_s


def _scalefacs(b, gi, g, scfsi, prev):
    s1 = T.SLEN1[gi["scalefac_compress"]]
    s2 = T.SLEN2[gi["scalefac_compress"]]
    sf_l = np.zeros(22, np.int64)
    sf_s = np.zeros((13, 3), np.int64)
    if gi["block_type"] == SHORT:
        for sfb in range(12):
            for w in range(3):
                sf_s[sfb, w] = b.get(s1 if sfb < 6 else s2)
    else:
        for band, (lo, hi) in enumerate(((0, 6), (6, 11), (11, 16), (16, 21))):
            if g == 1 and scfsi[band]:
                sf_l[lo:hi] = prev[lo:hi]
            else:
                for sfb in range(lo, hi):
                    sf_l[sfb] = b.get(s1 if band < 2 else s2)
    return sf_l, sf_s


def _spectrum(b, gi, end, sfb_l, sfb_s):
    """Huffman-decoded values of one granule in decoding order; raises
    ValueError on a code that no table holds or on a region that runs
    past ``end``."""
    ix = np.zeros(576, np.int64)
    if gi["block_type"] == SHORT:
        # region0_count 8: nine short bands counted a window each, the
        # first three bands' lines (36 at every MPEG-1 and LSF rate)
        r1, r2 = 3 * sfb_s[3], 576
    else:
        # window switched: region0_count 7, region1_count 13 (region 1
        # from long band 8: line 36 in MPEG-1, 54 in LSF)
        r1 = sfb_l[min(gi["region0_count"] + 1, 22)]
        r2 = sfb_l[min(gi["region0_count"] + gi["region1_count"] + 2, 22)]
    for i in range(0, 2 * gi["big_values"], 2):
        t = gi["table_select"][0 if i < r1 else (1 if i < r2 else 2)]
        if t == 0:
            continue
        if t in (4, 14):
            raise ValueError(f"table {t} does not exist")
        e = _lut(t)[b.peek(PEEK)]
        if e == 0:
            raise ValueError(f"no code of table {t}")
        b.pos += e & 0xFF
        x, y = e >> 16, (e >> 8) & 0xFF
        lin = int(T.HUFF_LINBITS[t])
        if lin and x == 15:
            x += b.get(lin)
        if x and b.get(1):
            x = -x
        if lin and y == 15:
            y += b.get(lin)
        if y and b.get(1):
            y = -y
        ix[i], ix[i + 1] = x, y
    if b.pos > end:
        raise ValueError("big values run past part2_3_length")
    i, lut = 2 * gi["big_values"], _lut(32 + gi["count1table_select"])
    while b.pos < end:
        if i > 572:
            raise ValueError("count1 quads past line 576")
        e = lut[b.peek(PEEK)]
        if e == 0:
            raise ValueError("no count1 code")
        b.pos += e & 0xFF
        p = (e >> 8) & 0xFF
        for k in range(4):
            v = (p >> (3 - k)) & 1
            if v and b.get(1):
                v = -1
            ix[i + k] = v
        i += 4
    if b.pos != end:
        raise ValueError("count1 quads run past part2_3_length")
    if gi["block_type"] == SHORT:
        nat = np.zeros(576, np.int64)
        j = 0
        for sfb in range(13):
            for w in range(3):
                for line in range(sfb_s[sfb], sfb_s[sfb + 1]):
                    nat[3 * line + w] = ix[j]
                    j += 1
        ix = nat
    return ix


def decode_frame(data, frames, f, rate_hz):
    """Frame f's granules: [(granule, channel, side info, sf_l, sf_s,
    ix in the encoder's layout: 18 lines a subband, short blocks'
    windows interleaved as ix[3 line + window])]."""
    fr = frames[f]
    sfb_l, sfb_s = T.SFB_LONG[rate_hz], T.SFB_SHORT[rate_hz]
    b = Bits(_main_data(data, frames, f))
    si = fr["si"]
    nch, ngr = len(si["scfsi"]), len(si["gr"])
    out, prev = [], [None] * nch
    for g in range(ngr):
        for ch in range(nch):
            gi = si["gr"][g][ch]
            end = b.pos + gi["part2_3_length"]
            if ngr == 1:
                sf_l, sf_s = _scalefacs_lsf(b, gi)
            else:
                sf_l, sf_s = _scalefacs(b, gi, g, si["scfsi"][ch], prev[ch])
            prev[ch] = sf_l
            ix = _spectrum(b, gi, end, sfb_l, sfb_s)
            out.append((ngr * f + g, ch, gi, sf_l, sf_s, ix))
    return out


def analysis(pcm, granules, block_types, dtype=torch.float64):
    """MDCT spectra xr (len(granules), 576) of one channel's int16 PCM at
    the given granules under the given block types: the polyphase
    filterbank (Annex C.1.3) and the MDCT with aliasing reduction
    (2.4.3.4.10), every product and sum in `dtype`."""
    g = np.asarray(granules, np.int64)
    # shifts 18 (g - 1) .. 18 g + 17; shift t reads x[32 t + 31 - i]
    t = 18 * (g[:, None] - 1) + np.arange(36)[None, :]        # (n, 36)
    idx = 32 * t[..., None] + 31 - np.arange(512)[None, None, :]
    x = np.where((idx >= 0) & (idx < len(pcm)),
                 pcm[np.clip(idx, 0, len(pcm) - 1)], 0)
    x = torch.from_numpy(x / 32768.0).to(dtype)
    z = x * torch.from_numpy(T.ENWINDOW).to(dtype)
    y = z.reshape(*z.shape[:2], 8, 64).sum(2)
    s = y @ torch.from_numpy(T.ANALYSIS.T).to(dtype)          # (n, 36, 32)
    s = torch.where(torch.from_numpy(t < 0)[..., None], 0, s)
    sign = torch.ones(36, 32, dtype=dtype)
    sign[1::2, 1::2] = -1                                     # odd slot, band
    s = (s * sign).transpose(1, 2)                            # (n, 32, 36)
    out = torch.zeros(len(g), 32, 18, dtype=dtype)
    bt = torch.as_tensor(np.asarray(block_types))
    for b in (NORM, START, STOP):
        m = bt == b
        if m.any():
            w = torch.from_numpy(T.MDCT_WIN[b]).to(dtype)
            out[m] = (s[m] * w) @ torch.from_numpy(T.MDCT_LONG.T).to(dtype)
    m = bt == SHORT
    if m.any():
        w = torch.from_numpy(T.MDCT_WIN[SHORT][:12]).to(dtype)
        basis = torch.from_numpy(T.MDCT_SHORT.T).to(dtype)
        res = torch.zeros(int(m.sum()), 32, 18, dtype=dtype)
        for k in range(3):
            res[..., k::3] = (s[m][..., 6 * k + 6: 6 * k + 18] * w) @ basis
        out[m] = res
    m = bt != SHORT
    if m.any():
        o = out[m]
        cs = torch.from_numpy(T.ALIAS_CS).to(dtype)
        ca = torch.from_numpy(T.ALIAS_CA).to(dtype)
        lo = o[:, :31, 17 - np.arange(8)].clone()             # (n, 31, 8)
        hi = o[:, 1:, :8].clone()
        o[:, :31, 17 - np.arange(8)] = lo * cs + hi * ca
        o[:, 1:, :8] = hi * cs - lo * ca
        out[m] = o
    return out.reshape(len(g), 576)


def exponents(grans, rate_hz):
    """(n, 576) float64: each line's quantizer exponent e under its
    granule's gains and scale factors (``decode_frame``'s records), so
    that a line quantizes as (|xr| 2^e)^0.75 and decodes as
    |ix|^(4/3) 2^-e (2.4.3.4.7.1)."""
    sfb_l, sfb_s = T.SFB_LONG[rate_hz], T.SFB_SHORT[rate_hz]
    expo = np.zeros((len(grans), 576))
    for r, (_, _, gi, sf_l, sf_s, _) in enumerate(grans):
        mult = 0.5 * (1 + gi["scalefac_scale"])
        gg = (gi["global_gain"] - 210) / 4.0
        if gi["block_type"] == SHORT:
            e = np.zeros((192, 3))
            for sfb in range(13):
                lo, hi = sfb_s[sfb], sfb_s[sfb + 1]
                e[lo:hi] = mult * sf_s[sfb][None, :]
            e -= gg - 2.0 * np.asarray(gi["subblock_gain"])[None, :]
            expo[r] = e.reshape(576)
        else:
            a = mult * (sf_l + gi["preflag"] * T.PRETAB)
            expo[r] = np.repeat(a, np.diff(sfb_l)) - gg
    return expo


def requantize(xr, grans, rate_hz, dtype=torch.float64):
    """The quantized magnitudes of xr (n, 576) under each granule's gains
    and scale factors (``decode_frame``'s records): nint(v^0.75 -
    0.0946), i.e. floor(v^0.75 + 0.4054), in `dtype`."""
    expo = exponents(grans, rate_hz)
    v = xr.abs() * torch.exp2(torch.from_numpy(expo).to(dtype))
    q = torch.floor(v.to(dtype) ** 0.75 + 0.4054)
    return q.to(torch.float64).numpy().astype(np.int64)


def dequantize(grans, rate_hz):
    """(n, 576) float64: the granules' lines as a decoder reads them,
    sign(ix) |ix|^(4/3) 2^-e, on the scale of ``analysis``."""
    ix = np.stack([g[5] for g in grans]).astype(np.float64)
    return np.sign(ix) * np.abs(ix) ** (4.0 / 3.0) * np.exp2(
        -exponents(grans, rate_hz))
