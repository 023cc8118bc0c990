"""MPEG-1 Layer III decoder (NumPy, test/metrics use).

Implements the full decode chain per ISO 11172-3 2.4.3.4: frame sync,
side-info parse, bit-reservoir main_data reassembly, scalefactor and
Huffman decode, requantization, short-block reordering, alias
reduction, IMDCT with overlap-add, frequency inversion, and the
polyphase synthesis filterbank.

Used by the test-suite to verify decodability of encoder output and to
compute decoded-SNR quality metrics (BASELINE.md requires decoded SNR
>= reference at every bitrate).  Not a performance path.
"""
import numpy as np

from ..tables import mpeg
from ..tables.dsp import ENWINDOW, MDCT_WIN, REF_PI
from ..tables.huffman import HUFF

ALIAS_C = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_cs = 1.0 / np.sqrt(1.0 + ALIAS_C ** 2)
_ca = ALIAS_C / np.sqrt(1.0 + ALIAS_C ** 2)


class BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0  # bit position

    def get(self, n):
        if n == 0:
            return 0
        v = 0
        for _ in range(n):
            byte = int(self.data[self.pos >> 3])
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return int(v)


def _build_decode_tables():
    """code->(x,y) maps per table as dict[(length, code)]."""
    tabs = {}
    for t in range(34):
        n = 16 if t >= 32 else int(HUFF.xlen[t])
        if n == 0:
            continue
        m = {}
        if t >= 32:
            for p in range(16):
                m[(int(HUFF.hlen[t, 0, p]), int(HUFF.codes[t, 0, p]))] = p
        else:
            for x in range(n):
                for y in range(n):
                    m[(int(HUFF.hlen[t, x, y]), int(HUFF.codes[t, x, y]))] = (x, y)
        tabs[t] = m
    return tabs


_DEC = _build_decode_tables()


def _huff_decode(br, table):
    m = _DEC[table]
    code = 0
    length = 0
    while length < 20:
        code = (code << 1) | br.get(1)
        length += 1
        if (length, code) in m:
            return m[(length, code)]
    raise ValueError("bad huffman code")


def _parse_header(data, i):
    if i + 4 > len(data) or data[i] != 0xFF or (data[i + 1] & 0xF0) != 0xF0:
        return None
    b1, b2, b3 = int(data[i + 1]), int(data[i + 2]), int(data[i + 3])
    version = (b1 >> 3) & 1
    layer = 4 - ((b1 >> 1) & 3)
    protection = not (b1 & 1)
    bitrate_index = b2 >> 4
    sampling_frequency = (b2 >> 2) & 3
    padding = (b2 >> 1) & 1
    mode = (b3 >> 6) & 3
    return dict(version=version, layer=layer, protection=protection,
                bitrate_index=bitrate_index,
                sampling_frequency=sampling_frequency, padding=padding,
                mode=mode)


def _parse_side_info(br, nch, version=1):
    """Side info for MPEG-1 (two granules, 9-bit back-pointer, scfsi)
    or MPEG-2 LSF (one granule, 8-bit back-pointer, 9-bit
    scalefac_compress, no scfsi/preflag bits; IS 13818-3 2.4.1.7)."""
    mpeg1 = version == 1
    if mpeg1:
        si = dict(main_data_begin=br.get(9),
                  private=br.get(3 if nch == 2 else 5),
                  scfsi=[[br.get(1) for _ in range(4)] for _ in range(nch)],
                  gr=[])
    else:
        si = dict(main_data_begin=br.get(8),
                  private=br.get(2 if nch == 2 else 1),
                  scfsi=[[0] * 4 for _ in range(nch)], gr=[])
    # note scfsi loop order: per channel 4 bands (l3bitstream.c:362-367)
    for g in range(2 if mpeg1 else 1):
        chs = []
        for ch in range(nch):
            gi = dict(part2_3_length=br.get(12), big_values=br.get(9),
                      global_gain=br.get(8),
                      scalefac_compress=br.get(4 if mpeg1 else 9),
                      window_switching_flag=br.get(1))
            if gi["window_switching_flag"]:
                gi["block_type"] = br.get(2)
                gi["mixed_block_flag"] = br.get(1)
                gi["table_select"] = [br.get(5), br.get(5), 0]
                gi["subblock_gain"] = [br.get(3) for _ in range(3)]
                gi["region0_count"] = 7  # IS 2.4.2.7 defaults
                gi["region1_count"] = 20 - 7
            else:
                gi["block_type"] = 0
                gi["mixed_block_flag"] = 0
                gi["table_select"] = [br.get(5), br.get(5), br.get(5)]
                gi["subblock_gain"] = [0, 0, 0]
                gi["region0_count"] = br.get(4)
                gi["region1_count"] = br.get(3)
            if mpeg1:
                gi["preflag"] = br.get(1)
            else:
                # LSF: preflag is implied by the scalefac_compress range
                gi["preflag"] = 1 if gi["scalefac_compress"] >= 500 else 0
            gi["scalefac_scale"] = br.get(1)
            gi["count1table_select"] = br.get(1)
            chs.append(gi)
        si["gr"].append(chs)
    return si


_SLEN1 = mpeg.SLEN1_TAB
_SLEN2 = mpeg.SLEN2_TAB


def _decode_scalefacs(br, gi, gr, scfsi, prev):
    slen1 = int(_SLEN1[gi["scalefac_compress"]])
    slen2 = int(_SLEN2[gi["scalefac_compress"]])
    sf_l = np.zeros(22, np.int32)
    sf_s = np.zeros((13, 3), np.int32)
    if gi["window_switching_flag"] and gi["block_type"] == 2:
        for sfb in range(6):
            for w in range(3):
                sf_s[sfb, w] = br.get(slen1)
        for sfb in range(6, 12):
            for w in range(3):
                sf_s[sfb, w] = br.get(slen2)
    else:
        groups = [(0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2)]
        for band, (s, e, sl) in enumerate(groups):
            if gr == 1 and scfsi[band]:
                sf_l[s:e] = prev[0][s:e]
            else:
                for sfb in range(s, e):
                    sf_l[sfb] = br.get(sl)
    return sf_l, sf_s


def _decode_scalefacs_lsf(br, gi):
    """MPEG-2 LSF scalefactors (IS 13818-3 2.4.3.2): four slen values
    and an sfb partition derived from the 9-bit scalefac_compress."""
    sc = gi["scalefac_compress"]
    if sc < 400:
        table_number = 0
        slen = [(sc >> 4) // 5, (sc >> 4) % 5, (sc & 15) >> 2, sc & 3]
    elif sc < 500:
        s = sc - 400
        table_number = 1
        slen = [(s >> 2) // 5, (s >> 2) % 5, s & 3, 0]
    else:
        s = sc - 500
        table_number = 2
        slen = [s // 3, s % 3, 0, 0]
    short = gi["window_switching_flag"] and gi["block_type"] == 2
    mixed = short and gi["mixed_block_flag"]
    row = 2 if mixed else (1 if short else 0)
    part = mpeg.NR_OF_SFB_BLOCK[table_number][row]
    sf_l = np.zeros(22, np.int32)
    sf_s = np.zeros((13, 3), np.int32)
    if short and not mixed:
        sfb = 0
        for p in range(4):
            for _ in range(int(part[p]) // 3):
                for w in range(3):
                    sf_s[sfb, w] = br.get(slen[p])
                sfb += 1
    elif mixed:
        sfb = 0
        for _ in range(int(part[0])):
            sf_l[sfb] = br.get(slen[0])
            sfb += 1
        sfb = 0
        for p in range(1, 4):
            for _ in range(int(part[p]) // 3):
                for w in range(3):
                    sf_s[sfb, w] = br.get(slen[p])
                sfb += 1
    else:
        sfb = 0
        for p in range(4):
            for _ in range(int(part[p])):
                sf_l[sfb] = br.get(slen[p])
                sfb += 1
    return sf_l, sf_s


def _decode_spectrum(br, gi, sfb_l, sfb_s, part2_start):
    ix = np.zeros(576, np.int64)
    bv = gi["big_values"] * 2
    if gi["window_switching_flag"] and gi["block_type"] == 2:
        region1_start = 36
        region2_start = 576
    else:
        r0 = gi["region0_count"]
        r1 = gi["region1_count"]
        region1_start = int(sfb_l[min(r0 + 1, 22)])
        region2_start = int(sfb_l[min(r0 + r1 + 2, 22)])
    for i in range(0, bv, 2):
        if i < region1_start:
            t = gi["table_select"][0]
        elif i < region2_start:
            t = gi["table_select"][1]
        else:
            t = gi["table_select"][2]
        if t == 0:
            ix[i] = ix[i + 1] = 0
            continue
        x, y = _huff_decode(br, t)
        linbits = int(HUFF.linbits[t])
        if t > 15:
            if x == 15:
                x += br.get(linbits)
            if x:
                x = -x if br.get(1) else x
            if y == 15:
                y += br.get(linbits)
            if y:
                y = -y if br.get(1) else y
        else:
            if x:
                x = -x if br.get(1) else x
            if y:
                y = -y if br.get(1) else y
        ix[i], ix[i + 1] = x, y
    # count1
    i = bv
    limit = part2_start + gi["part2_3_length"]
    t = 32 + gi["count1table_select"]
    while br.pos < limit and i <= 572:
        p = _huff_decode(br, t)
        # conformant quad order: v (FIRST sample) at bit 3 -- verified
        # against libmpg123 (round 5).  NOTE: the dist10 reference
        # builds its index with v at bit 0 (l3bitstream.c:740), so its
        # count1 quads genuinely decode sample-reversed in conforming
        # decoders; this decoder reports the conformant view (matching
        # mpg123) rather than mirroring the reference's quirk.
        vals = [(p >> 3) & 1, (p >> 2) & 1, (p >> 1) & 1, (p >> 0) & 1]
        for k in range(4):
            v = vals[k]
            if v and br.pos < limit:
                v = -v if br.get(1) else v
            ix[i + k] = v
        i += 4
    br.pos = limit
    if gi["window_switching_flag"] and gi["block_type"] == 2:
        # short blocks arrive in (sfb, window, line) stream order
        # (l3bitstream.c:542-568 emits ix[3*line+w] per sfb/window);
        # reorder back to the natural interleaved (line, window) layout
        ix = _reorder_short(ix, sfb_s)
    return ix


def _short_perm(sfb_s):
    """Stream position j -> natural index 3*line + window."""
    perm = []
    for sfb in range(13):
        for w in range(3):
            for line in range(int(sfb_s[sfb]), int(sfb_s[sfb + 1])):
                perm.append(3 * line + w)
    return np.asarray(perm, np.int64)


def _reorder_short(ix_stream, sfb_s):
    key = tuple(int(x) for x in sfb_s)
    perm = _PERM_CACHE.get(key)
    if perm is None:
        perm = _short_perm(sfb_s)
        _PERM_CACHE[key] = perm
    ix = np.zeros_like(ix_stream)
    ix[perm] = ix_stream
    return ix


_PERM_CACHE = {}


_PRETAB = mpeg.PRETAB


def _requantize(ix, gi, sf_l, sf_s, sfb_l, sfb_s):
    xr = np.zeros(576)
    gg = gi["global_gain"]
    sfs = gi["scalefac_scale"]
    step_mult = 0.5 * (1 + sfs)
    if gi["window_switching_flag"] and gi["block_type"] == 2:
        # 13 bands: the last one (sfb 12) has no transmitted scalefactor
        # and requantizes with sf=0 (sf_s is zero there)
        ixs = ix.reshape(192, 3)
        xrs = np.zeros((192, 3))
        for sfb in range(13):
            s, e = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
            for w in range(3):
                gain = 2.0 ** (0.25 * (gg - 210 - 8 * gi["subblock_gain"][w])) \
                    * 2.0 ** (-step_mult * sf_s[sfb, w])
                seg = ixs[s:e, w]
                xrs[s:e, w] = np.sign(seg) * (np.abs(seg) ** (4.0 / 3.0)) * gain
        xr = xrs.reshape(576)
    else:
        # 22 bands: sfb 21 has no scalefactor (sf_l zero) and no pretab
        for sfb in range(22):
            s, e = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
            pre = int(_PRETAB[sfb]) if sfb < len(_PRETAB) else 0
            gain = 2.0 ** (0.25 * (gg - 210)) * 2.0 ** (
                -step_mult * (sf_l[sfb] + gi["preflag"] * pre))
            seg = ix[s:e]
            xr[s:e] = np.sign(seg) * (np.abs(seg) ** (4.0 / 3.0)) * gain
    return xr


_IMDCT_WIN = MDCT_WIN  # same windows


def _imdct_long(X, block_type):
    k = np.arange(18)
    t = np.arange(36)
    basis = np.cos(REF_PI / 72.0 * (2 * t[:, None] + 1 + 18) * (2 * k[None, :] + 1))
    x = basis @ X
    return x * _IMDCT_WIN[block_type]


def _imdct_short(X):
    """X: 18 values (3 interleaved sets of 6). Returns 36 samples."""
    k = np.arange(6)
    t = np.arange(12)
    basis = np.cos(REF_PI / 24.0 * (2 * t[:, None] + 1 + 6) * (2 * k[None, :] + 1))
    out = np.zeros(36)
    for w in range(3):
        xw = X[w::3]
        seg = (basis @ xw) * _IMDCT_WIN[2][:12]
        out[6 + 6 * w: 18 + 6 * w] += seg
    return out


def _synthesis_matrix():
    i = np.arange(64)[:, None]
    k = np.arange(32)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * REF_PI / 64.0)


_N_SYNTH = _synthesis_matrix()


class _Synth:
    def __init__(self):
        self.v = np.zeros(1024)

    def run(self, sb32):
        self.v = np.roll(self.v, 64)
        self.v[:64] = _N_SYNTH @ sb32
        u = np.zeros(512)
        for i in range(8):
            u[i * 64: i * 64 + 32] = self.v[i * 128: i * 128 + 32]
            u[i * 64 + 32: i * 64 + 64] = self.v[i * 128 + 96: i * 128 + 128]
        w = u * (ENWINDOW * 32.0)
        return np.sum(w.reshape(16, 32), axis=0)


def decode_mp3(data):
    """Decode an MPEG-1 or MPEG-2 LSF Layer III stream ->
    (pcm float (n, nch), rate)."""
    data = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    i = 0
    hdr0 = _parse_header(data, 0)
    assert hdr0 and hdr0["layer"] == 3
    version = hdr0["version"]
    mode_gr = 2 if version == 1 else 1
    nch = 1 if hdr0["mode"] == mpeg.MODE_MONO else 2
    sfidx = hdr0["sampling_frequency"]
    rate = int(mpeg.S_FREQ_KHZ[version][sfidx] * 1000)
    sfb_l = mpeg.sfb_long(version, sfidx)
    sfb_s = mpeg.sfb_short(version, sfidx)
    kbps = int(mpeg.BITRATE_KBPS[version][2][hdr0["bitrate_index"]])

    main_data = bytearray()
    frames = []
    while True:
        hdr = _parse_header(data, i)
        if hdr is None:
            break
        frame_size = (72000 if version == 0 else 144000) * kbps // rate \
            + hdr["padding"]
        raw = data[i: i + frame_size]
        if len(raw) < frame_size:
            break
        br = BitReader(raw)
        br.pos = 32
        if hdr["protection"]:
            br.get(16)
        si = _parse_side_info(br, nch, version)
        side_bytes = br.pos // 8
        frames.append((si, len(main_data)))
        main_data += bytes(raw[side_bytes:frame_size].tobytes()
                           if isinstance(raw, np.ndarray) else raw[side_bytes:])
        i += frame_size

    # decode per frame using main_data_begin back-pointers
    out = [[] for _ in range(nch)]
    overlap = np.zeros((nch, 32, 18))
    synth = [_Synth() for _ in range(nch)]
    prev_sf = [None] * nch
    for f, (si, md_end_offset) in enumerate(frames):
        start = md_end_offset - si["main_data_begin"]
        if start < 0:
            continue  # missing reservoir data at stream start
        br = BitReader(main_data)
        br.pos = start * 8
        for gr in range(mode_gr):
            for ch in range(nch):
                gi = si["gr"][gr][ch]
                part2_start = br.pos
                if version == 1:
                    sf_l, sf_s = _decode_scalefacs(
                        br, gi, gr, si["scfsi"][ch], [prev_sf[ch]] if prev_sf[ch] is not None else [np.zeros(22, np.int32)])
                else:
                    sf_l, sf_s = _decode_scalefacs_lsf(br, gi)
                if gr == 0:
                    prev_sf[ch] = sf_l
                ix = _decode_spectrum(br, gi, sfb_l, sfb_s, part2_start)
                xr = _requantize(ix, gi, sf_l, sf_s, sfb_l, sfb_s)
                # alias reduction (not for short blocks)
                xrb = xr.reshape(32, 18)
                if not (gi["window_switching_flag"] and gi["block_type"] == 2):
                    for sb in range(31):
                        for k in range(8):
                            lo = xrb[sb, 17 - k]
                            hi = xrb[sb + 1, k]
                            xrb[sb, 17 - k] = lo * _cs[k] - hi * _ca[k]
                            xrb[sb + 1, k] = hi * _cs[k] + lo * _ca[k]
                # IMDCT per subband + overlap add
                sb_samples = np.zeros((18, 32))
                for sb in range(32):
                    bt = gi["block_type"] if not (gi["mixed_block_flag"] and sb < 2) else 0
                    if bt == 2:
                        x36 = _imdct_short(xrb[sb])
                    else:
                        x36 = _imdct_long(xrb[sb], bt)
                    sb_samples[:, sb] = x36[:18] + overlap[ch][sb]
                    overlap[ch][sb] = x36[18:]
                # frequency inversion
                sb_samples[1::2, 1::2] *= -1.0
                for t in range(18):
                    out[ch].append(synth[ch].run(sb_samples[t]))
    pcm = np.stack([np.concatenate(o) if o else np.zeros(0) for o in out], axis=1)
    return pcm, rate


def snr_db(reference_pcm, decoded_pcm, skip=1057):
    """SNR of decoded vs source.  The encode+decode chain delay is
    exactly 481 (polyphase analysis+synthesis) + 576 (MDCT/IMDCT
    overlap) = 1057 samples, verified by loopback at ~90 dB."""
    n = min(len(reference_pcm), len(decoded_pcm)) - skip
    if n <= 0:
        return float("nan")
    a = np.asarray(reference_pcm[:n], np.float64)
    b = np.asarray(decoded_pcm[skip:skip + n], np.float64)
    # align scale: decoder output is in [-1,1] fractions of 32768
    if np.max(np.abs(b)) < 4.0:
        b = b * 32768.0
    num = np.sum(a * a)
    den = np.sum((a - b) ** 2)
    if den == 0:
        return float("inf")
    return 10.0 * np.log10(num / den)
