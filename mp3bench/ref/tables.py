"""Constants of ISO/IEC 11172-3 and of its extension to the lower
sampling frequencies, ISO/IEC 13818-3 (MPEG-2 LSF), that the plain
reference needs, frozen.

``standard.npz`` holds the tabulated constants of the standard: the
512-tap analysis window (Table C.1), the Layer III Huffman code tables
(Table B.7: codes, lengths, and per table x/y size, linbits, linmax) and
the five Layer II allocation tables (Table B.2, packed as the ISO
reference's ``alloc_*`` data).  It is a copy of arrays from
``mp3tpu_torch/tables/data/{iso_tables,huffman}.npz`` at commit 8dfe798;
everything else here is computed from the standard's formulas.  Later
changes to the program do not reach this copy.
"""
import os

import numpy as np

_D = np.load(os.path.join(os.path.dirname(__file__), "standard.npz"))

REF_PI = 3.14159265358979

ENWINDOW = _D["enwindow"]                      # (512,)


def _analysis_matrix():
    """M[i, k] = cos((2i + 1)(16 - k) pi / 64), the standard's matrixing
    (Figure C.4), rounded to 1e-9 as the standard's tables are."""
    i = np.arange(32)[:, None]
    k = np.arange(64)[None, :]
    m = 1e9 * np.cos((2 * i + 1) * (16 - k) * REF_PI / 64.0)
    return np.where(m >= 0, np.floor(m + 0.5), np.ceil(m - 0.5)) * 1e-9


ANALYSIS = _analysis_matrix()                  # (32, 64)


def _mdct_windows():
    """Layer III windows by block type (2.4.3.4.10.3): normal, start,
    short (the 12-point window in its first 12 taps), stop."""
    w = np.zeros((4, 36))
    i = np.arange(36)
    w[0] = np.sin(REF_PI / 36 * (i + 0.5))
    w[1, :18] = np.sin(REF_PI / 36 * (i[:18] + 0.5))
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(REF_PI / 12 * (i[24:30] + 0.5 - 18))
    w[2, :12] = np.sin(REF_PI / 12 * (i[:12] + 0.5))
    w[3, 6:12] = np.sin(REF_PI / 12 * (i[6:12] + 0.5 - 6))
    w[3, 12:18] = 1.0
    w[3, 18:] = np.sin(REF_PI / 36 * (i[18:] + 0.5))
    return w


MDCT_WIN = _mdct_windows()


def _mdct_basis(n):
    """(n/2, n) MDCT basis with the ISO encoder's 4/n scale."""
    m = np.arange(n // 2)[:, None]
    k = np.arange(n)[None, :]
    return np.cos(REF_PI / (2 * n) * (2 * k + 1 + n // 2) * (2 * m + 1)) \
        / (n / 4)


MDCT_LONG = _mdct_basis(36)                    # (18, 36)
MDCT_SHORT = _mdct_basis(12)                   # (6, 12)

# aliasing-reduction coefficients (Table B.9)
_C = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
ALIAS_CS = 1.0 / np.sqrt(1.0 + _C * _C)
ALIAS_CA = _C / np.sqrt(1.0 + _C * _C)

# --- frame header
BITRATE_KBPS = {(1, 3): [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192,
                         224, 256, 320],
                (1, 2): [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
                         256, 320, 384]}
SAMPLE_RATE_INDEX = {44100: 0, 48000: 1, 32000: 2}
MODES = {"stereo": 0, "joint_stereo": 1, "dual_channel": 2, "mono": 3}

# --- MPEG-2 LSF header (ISO/IEC 13818-3 2.4.2.3): the ID bit is 0, and
# the sampling_frequency and bitrate_index fields name the lower rates
LSF_SAMPLE_RATE_INDEX = {22050: 0, 24000: 1, 16000: 2}
BITRATE_KBPS[(0, 3)] = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
                        144, 160]

# --- Layer III (MPEG-1) scalefactor bands (Table B.8)
SFB_LONG = {44100: [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110,
                    134, 162, 196, 238, 288, 342, 418, 576],
            48000: [0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106,
                    128, 156, 190, 230, 276, 330, 384, 576],
            32000: [0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126,
                    156, 194, 240, 296, 364, 448, 550, 576]}
SFB_SHORT = {44100: [0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192],
             48000: [0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192],
             32000: [0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192]}
# --- Layer III (MPEG-2 LSF) scalefactor bands (13818-3 Table B.2).  At
# 24 kHz the long bands 17 and 18 are 54 and 62 lines wide (edge 332),
# as the standard's table gives them
SFB_LONG.update({
    22050: [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
            238, 284, 336, 396, 464, 522, 576],
    24000: [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194,
            232, 278, 332, 394, 464, 540, 576],
    16000: [0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
            238, 284, 336, 396, 464, 522, 576]})
SFB_SHORT.update({
    22050: [0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192],
    24000: [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192],
    16000: [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]})
# nr_of_sfb[table][block][partition] (13818-3 2.4.3.2): the scale factors
# that each of the four slen widths covers; tables 0-2 for channels
# without intensity stereo, 3-5 for the intensity-coded right channel;
# blocks: long (block_type != 2), short (counted a window each), mixed
NR_OF_SFB = [[[6, 5, 5, 5], [9, 9, 9, 9], [6, 9, 9, 9]],
             [[6, 5, 7, 3], [9, 9, 12, 6], [6, 9, 12, 6]],
             [[11, 10, 0, 0], [18, 18, 0, 0], [15, 18, 0, 0]],
             [[7, 7, 7, 0], [12, 12, 12, 0], [6, 15, 12, 0]],
             [[6, 6, 6, 3], [12, 9, 9, 6], [6, 12, 9, 6]],
             [[8, 8, 5, 0], [15, 12, 9, 0], [6, 18, 9, 0]]]
PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3,
                   2, 0])
SLEN1 = [0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4]
SLEN2 = [0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3]

HUFF_CODES = _D["huff_codes"].astype(np.int64)   # (34, 16, 16)
HUFF_HLEN = _D["huff_hlen"].astype(np.int64)
HUFF_XLEN, _, HUFF_LINBITS, _ = _D["huff_meta"].T

# --- Layer II
MULTIPLE = np.round(np.array([2.0 ** (1.0 - i / 3.0) for i in range(63)])
                    * 1e14) / 1e14             # Table B.1, 14 decimals
QUANT_A = np.array([
    0.750000000, 0.625000000, 0.875000000, 0.562500000, 0.937500000,
    0.968750000, 0.984375000, 0.992187500, 0.996093750, 0.998046875,
    0.999023438, 0.999511719, 0.999755859, 0.999877930, 0.999938965,
    0.999969482, 0.999984741])
QUANT_B = np.array([
    -0.250000000, -0.375000000, -0.125000000, -0.437500000, -0.062500000,
    -0.031250000, -0.015625000, -0.007812500, -0.003906250, -0.001953125,
    -0.000976563, -0.000488281, -0.000244141, -0.000122070, -0.000061035,
    -0.000030518, -0.000015259])
# scale factors sent for each scfsi value (2.4.2.6)
SFS_PER_SCFSI = [3, 2, 1, 2]
# the ISO encoder's scfsi choice from the two steps' classes (C.1.5.2.5)
SCFSI_PATTERN = [[0x123, 0x122, 0x122, 0x133, 0x123],
                 [0x113, 0x111, 0x111, 0x444, 0x113],
                 [0x111, 0x111, 0x111, 0x333, 0x113],
                 [0x222, 0x222, 0x222, 0x333, 0x123],
                 [0x123, 0x122, 0x122, 0x133, 0x123]]
JS_BOUND_L2 = [4, 8, 12, 16]


def _unpack_alloc(flat):
    """[sblimit, (sb, j, steps, bits, group, quant)*, end] -> arrays;
    row j = 0's ``bits`` is the width of the allocation field."""
    flat = np.where(np.asarray(flat, np.int64) == 0xFFFFFFFF, -1,
                    np.asarray(flat, np.int64))
    out = {k: np.zeros((32, 16), np.int64)
           for k in ("steps", "bits", "group", "quant")}
    p = 1
    while flat[p] != -1:
        sb, j, s, b, g, q = (int(v) for v in flat[p:p + 6])
        out["steps"][sb, j], out["bits"][sb, j] = s, b
        out["group"][sb, j], out["quant"][sb, j] = g, q
        p += 6
    out["sblimit"] = int(flat[0])
    out["nbal"] = out["bits"][:, 0].copy()
    return out


ALLOC = [_unpack_alloc(_D[f"alloc_{i}"]) for i in range(5)]


def layer2_table(rate_hz, kbps, nch):
    """The allocation table for an MPEG-1 Layer II stream (B.2 a-d by
    rate and bitrate per channel)."""
    per_ch = kbps // nch
    khz = rate_hz // 1000
    if (khz == 48 and per_ch >= 56) or 56 <= per_ch <= 80:
        return ALLOC[0]
    if khz != 48 and per_ch >= 96:
        return ALLOC[1]
    if khz != 32 and per_ch <= 48:
        return ALLOC[2]
    return ALLOC[3]
