"""Layer III bitstream assembly: side info, scalefactors, Huffman data,
and the main_data_begin back-pointer engine.

Byte-exact reimplementation of l3bitstream.c + formatBitstream.c:
  - MSB-first bit writer (common.c:1134-1160)
  - header/side-info field layout (l3bitstream.c:314-458)
  - scalefactor emission with scfsi (l3bitstream.c:195-254)
  - Huffman codeword emission incl. ESC linbits and sign packing
    (l3bitstream.c:516-716, 783-906), ones-stuffing to part2_3_length
  - side-info FIFO realizing the back-pointer (formatBitstream.c:52-80,
    218-247): main data bits are interleaved with queued headers, and
    nextBackPtr = (BitsRemaining + fwdFrame - fwdSI)/8.

The production path reimplements this in C++ (native/mp3bits.cpp); this
Python version is the oracle used in tests.
"""
import numpy as np

from ..tables import mpeg
from ..tables.huffman import HUFF


class BitWriter:
    """MSB-first accumulating bit writer."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, val, n):
        if n == 0:
            return
        self.acc = (self.acc << n) | (int(val) & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def tell_bits(self):
        return len(self.buf) * 8 + self.nbits

    def bytes(self):
        assert self.nbits == 0
        return bytes(self.buf)


def encode_header(cfg, padding):
    """32-bit frame header as (value,length) list (l3bitstream.c:322-334)."""
    return [
        (0xFFF, 12), (cfg.version, 1), (4 - cfg.layer, 2),
        (0 if cfg.error_protection else 1, 1), (cfg.bitrate_index, 4),
        (cfg.sampling_frequency, 2), (padding, 1), (cfg.extension, 1),
        (cfg.mode, 2), (cfg.mode_ext, 2), (int(cfg.copyright), 1),
        (int(cfg.original), 1), (cfg.emphasis, 2),
    ]


CRC16_POLYNOMIAL = 0x8005


def _update_crc16(data, length, crc):
    """common.c:1311-1324 bitwise CRC-16 update."""
    masking = 1 << length
    while True:
        masking >>= 1
        if not masking:
            break
        carry = crc & 0x8000
        crc = (crc << 1) & 0xFFFF
        if (not carry) != (not (data & masking)):
            crc ^= CRC16_POLYNOMIAL
    return crc


def insert_crc16(si):
    """ISO 11172-3 Layer III error protection: CRC-16 (init 0xffff,
    poly 0x8005, common.c:1251-1324) over header bits 16..31 (si[4:13])
    plus the whole side info (si[13:]), inserted after the header.
    Deliberate improvement over the reference, which accounts the 16
    bits (musicin.c:723) but emits a never-computed static 0
    (l3bitstream.c:312)."""
    crc = 0xFFFF
    for v, l in si[4:]:
        crc = _update_crc16(int(v), int(l), crc)
    return si[:13] + [(crc, 16)] + si[13:]


def encode_side_info(cfg, side):
    """Side info elements after the header (l3bitstream.c:344-456).

    side: dict with main_data_begin, private_bits, scfsi[ch][4],
          granules: list[gr][ch] of GrInfo.
    """
    el = []
    nch = cfg.nchannels
    if cfg.version == mpeg.MPEG1:
        el.append((side["main_data_begin"], 9))
        el.append((side["private_bits"], 3 if nch == 2 else 5))
        for ch in range(nch):
            for b in range(4):
                el.append((side["scfsi"][ch][b], 1))
        for gr in range(2):
            for ch in range(nch):
                gi = side["granules"][gr][ch]
                el += _spectrum_si(gi, mpeg1=True)
    else:
        el.append((side["main_data_begin"], 8))
        el.append((side["private_bits"], 2 if nch == 2 else 1))
        for ch in range(nch):
            gi = side["granules"][0][ch]
            el += _spectrum_si(gi, mpeg1=False)
    return el


def _spectrum_si(gi, mpeg1):
    el = [
        (gi.part2_3_length, 12), (gi.big_values, 9), (gi.global_gain, 8),
        (gi.scalefac_compress, 4 if mpeg1 else 9),
        (gi.window_switching_flag, 1),
    ]
    if gi.window_switching_flag:
        el.append((gi.block_type, 2))
        el.append((gi.mixed_block_flag, 1))
        for r in range(2):
            el.append((gi.table_select[r], 5))
        for w in range(3):
            el.append((gi.subblock_gain[w], 3))
    else:
        assert gi.block_type == 0
        for r in range(3):
            el.append((gi.table_select[r], 5))
        el.append((gi.region0_count, 4))
        el.append((gi.region1_count, 3))
    el.append((gi.preflag, 1)) if mpeg1 else None
    el.append((gi.scalefac_scale, 1))
    el.append((gi.count1table_select, 1))
    return el


def encode_scalefacs(gi, scalefac_l, scalefac_s, scfsi, gr, version):
    """Scalefactor part of main_data (l3bitstream.c:195-306)."""
    el = []
    if version == mpeg.MPEG1:
        slen1 = int(mpeg.SLEN1_TAB[gi.scalefac_compress])
        slen2 = int(mpeg.SLEN2_TAB[gi.scalefac_compress])
        if gi.window_switching_flag == 1 and gi.block_type == 2:
            for sfb in range(6):
                for w in range(3):
                    el.append((int(scalefac_s[sfb, w]), slen1))
            for sfb in range(6, 12):
                for w in range(3):
                    el.append((int(scalefac_s[sfb, w]), slen2))
        else:
            if gr == 0 or scfsi[0] == 0:
                for sfb in range(0, 6):
                    el.append((int(scalefac_l[sfb]), slen1))
            if gr == 0 or scfsi[1] == 0:
                for sfb in range(6, 11):
                    el.append((int(scalefac_l[sfb]), slen1))
            if gr == 0 or scfsi[2] == 0:
                for sfb in range(11, 16):
                    el.append((int(scalefac_l[sfb]), slen2))
            if gr == 0 or scfsi[3] == 0:
                for sfb in range(16, 21):
                    el.append((int(scalefac_l[sfb]), slen2))
    else:
        row = mpeg.NR_OF_SFB_BLOCK[gi.sfb_partition_table // 3][gi.sfb_partition_table % 3]
        if gi.window_switching_flag == 1 and gi.block_type == 2:
            sfb = 0
            for p in range(4):
                for _ in range(int(row[p]) // 3):
                    for w in range(3):
                        el.append((int(scalefac_s[sfb, w]), gi.slen[p]))
                    sfb += 1
        else:
            sfb = 0
            for p in range(4):
                for _ in range(int(row[p])):
                    el.append((int(scalefac_l[sfb]), gi.slen[p]))
                    sfb += 1
    return [(v, l) for v, l in el if l]


def huffman_code(table, x, y):
    """(code,cbits),(ext,xbits) for one pair (l3bitstream.c:783-906)."""
    if table == 0:
        return 0, 0, 0, 0
    signx = 1 if x < 0 else 0
    signy = 1 if y < 0 else 0
    x, y = abs(x), abs(y)
    ylen = int(HUFF.ylen[table])
    linbits = int(HUFF.linbits[table])
    code = ext = cbits = xbits = 0
    if table > 15:
        linx = liny = 0
        xc, yc = x, y
        if xc > 14:
            linx = xc - 15
            xc = 15
        if yc > 14:
            liny = yc - 15
            yc = 15
        code = int(HUFF.codes[table, xc, yc])
        cbits = int(HUFF.hlen[table, xc, yc])
        if x > 14:
            ext = linx
            xbits += linbits
        if x != 0:
            ext = (ext << 1) | signx
            xbits += 1
        if y > 14:
            ext = (ext << linbits) | liny
            xbits += linbits
        if y != 0:
            ext = (ext << 1) | signy
            xbits += 1
    else:
        code = int(HUFF.codes[table, x, y])
        cbits = int(HUFF.hlen[table, x, y])
        if x != 0:
            code = (code << 1) | signx
            cbits += 1
        if y != 0:
            code = (code << 1) | signy
            cbits += 1
    return code, cbits, ext, xbits


def encode_spectrum(gi, ix_signed, sfb_s, count1_conformant=False):
    """Huffman-coded main data for one granule (l3bitstream.c:516-716).

    ix_signed: int array of 576 quantized values with signs applied.
    Returns element list; stuffing is appended by the caller once
    part2_length is known.

    count1_conformant: the reference indexes count1 quads with the
    FIRST sample at bit 0 (l3bitstream.c:740), which decodes
    sample-reversed in conforming decoders (verified vs libmpg123).
    Default False reproduces the reference byte-exactly (this module's
    purpose); True uses the conformant (v<<3)|(w<<2)|(x<<1)|y index
    like the production path (ops/jaxbits.count1_elements).
    """
    el = []
    bits_written = 0
    ix = ix_signed
    bigvalues = gi.big_values * 2
    if bigvalues:
        if (not gi.mixed_block_flag) and gi.window_switching_flag and gi.block_type == 2:
            ixs = ix.reshape(192, 3)
            for sfb in range(13):
                start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
                t = gi.table_select[0] if start < 12 else gi.table_select[1]
                for w in range(3):
                    for line in range(start, end, 2):
                        c, cb, e, xb = huffman_code(t, int(ixs[line, w]), int(ixs[line + 1, w]))
                        if cb:
                            el.append((c, cb))
                        if xb:
                            el.append((e, xb))
                        bits_written += cb + xb
        else:
            region1 = gi.address1
            region2 = gi.address2
            for i in range(0, bigvalues, 2):
                t = (gi.table_select[0] if i < region1 else
                     gi.table_select[1] if i < region2 else gi.table_select[2])
                if t:
                    c, cb, e, xb = huffman_code(t, int(ix[i]), int(ix[i + 1]))
                    if cb:
                        el.append((c, cb))
                    if xb:
                        el.append((e, xb))
                    bits_written += cb + xb
    # count1 quads
    h = 32 + gi.count1table_select
    count1end = bigvalues + gi.count1 * 4
    for i in range(bigvalues, count1end, 4):
        vals = [int(ix[i]), int(ix[i + 1]), int(ix[i + 2]), int(ix[i + 3])]
        signs = [1 if v < 0 else 0 for v in vals]
        avals = [abs(v) for v in vals]
        if count1_conformant:
            p = (avals[0] << 3) + (avals[1] << 2) + (avals[2] << 1) + avals[3]
        else:
            p = avals[0] + (avals[1] << 1) + (avals[2] << 2) + (avals[3] << 3)
        el.append((int(HUFF.codes[h, 0, p]), int(HUFF.hlen[h, 0, p])))
        bits_written += int(HUFF.hlen[h, 0, p])
        for v, sg in zip(avals, signs):
            if v:
                el.append((sg, 1))
                bits_written += 1
    # ones-stuffing to part2_3_length (l3bitstream.c:695-710)
    stuffing = gi.part2_3_length - gi.part2_length - bits_written
    assert stuffing >= 0, (gi.part2_3_length, gi.part2_length, bits_written)
    while stuffing >= 32:
        el.append((0xFFFFFFFF, 32))
        stuffing -= 32
    if stuffing:
        el.append(((1 << stuffing) - 1, stuffing))
    return el


class FrameAssembler:
    """formatBitstream.c engine: side-info FIFO + main-data interleaver."""

    def __init__(self):
        self.bw = BitWriter()
        self.queue = []           # [(frame_len_bits, si_elements)]
        self.bit_count = 0
        self.this_frame_size = 0
        self.bits_remaining = 0

    def _write_side_info(self):
        frame_len, si = self.queue.pop(0)
        self.this_frame_size = frame_len
        bits = 0
        for v, l in si:
            self.bw.put(v, l)
            bits += l
        return bits

    def _write_main_bits(self, val, nbits):
        if self.bit_count == self.this_frame_size:
            self.bit_count = self._write_side_info()
            self.bits_remaining = self.this_frame_size - self.bit_count
        if nbits == 0:
            return
        if nbits > self.bits_remaining:
            extra = val >> (nbits - self.bits_remaining)
            nbits -= self.bits_remaining
            self.bw.put(extra, self.bits_remaining)
            self.bit_count = self._write_side_info()
            self.bits_remaining = self.this_frame_size - self.bit_count
            self.bw.put(val, nbits)
        else:
            self.bw.put(val, nbits)
        self.bit_count += nbits
        self.bits_remaining -= nbits
        assert self.bit_count <= self.this_frame_size
        assert self.bits_remaining >= 0

    def add_frame(self, frame_len_bits, si_elements, main_elements):
        si_len = sum(l for _, l in si_elements)
        self.queue.append((frame_len_bits, si_elements))
        for v, l in main_elements:
            self._write_main_bits(v, l)
        assert self.bits_remaining % 8 == 0
        fwd_frame = sum(fl for fl, _ in self.queue)
        fwd_si = sum(sum(l for _, l in si) for _, si in self.queue)
        next_back_ptr = (self.bits_remaining // 8) + (fwd_frame // 8) - (fwd_si // 8)
        return next_back_ptr, si_len

    def flush(self):
        """BF_FlushBitstream: zero-fill remaining queued main data."""
        fwd_frame = sum(fl for fl, _ in self.queue)
        fwd_si = sum(sum(l for _, l in si) for _, si in self.queue)
        if self.queue:
            remaining = fwd_frame - fwd_si
            while remaining >= 32:
                self._write_main_bits(0, 32)
                remaining -= 32
            self._write_main_bits(0, remaining)
        # close_bit_stream_w (common.c:968-972) always emits the current
        # in-progress byte, which is a fresh zero byte when aligned
        out = self.bw.bytes()
        return out + b"\x00"
