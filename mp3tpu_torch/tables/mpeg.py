"""MPEG-1 / MPEG-2-LSF framing constants and Layer III side tables.

All values are normative ISO data.  Citations reference the upstream
ISO reference encoder for parity checking:
  - bitrate / s_freq tables: common.c:115-125
  - scalefactor band edges (Tables B.8/B.2): loop.c:65-92
  - preemphasis table (Table B.6): loop.c:150-154
  - scfsi partitioning: loop.c:157
  - slen code tables (Table B.5 scalefac_compress): loop.c:740-741
  - region subdivision table: loop.c:1596-1625
  - MPEG-2 LSF scalefactor partitions: loop.c:102-147
"""
import numpy as np

# The reference encoder computes every trig table with this truncated
# value of pi (common.h:200); we reuse it so the DSP matches bit-for-bit.
REF_PI = 3.14159265358979
LN_TO_LOG10 = 0.2302585093  # common.h:204 (dB -> ln), deliberately truncated

MPEG1, MPEG2_LSF = 1, 0  # header "version" field semantics (common.c:112)

# kHz; index: [version][sampling_frequency code]
S_FREQ_KHZ = np.array([[22.05, 24.0, 16.0, 0.0], [44.1, 48.0, 32.0, 0.0]])

# kbit/s; index: [version][layer-1][bitrate_index]
BITRATE_KBPS = np.array([
    [[0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256],
     [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
     [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]],
    [[0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448],
     [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384],
     [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]],
], dtype=np.int32)

MODE_STEREO, MODE_JOINT, MODE_DUAL, MODE_MONO = 0, 1, 2, 3

# Layer III scalefactor band edges, long (23 entries) and short (14),
# indexed by sampling_frequency + 3*version.
SFBAND = [
    # MPEG-2 LSF (version 0)
    dict(l=[0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
            238, 284, 336, 396, 464, 522, 576],
         s=[0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192]),  # 22.05
    # 24 kHz: dist10's loop.c table ends long band 17 at 330; we use
    # IS 13818-3 Table B.2's 332 (bands 17 and 18 of 54 and 62 lines),
    # as decoders do: they give lines 330-331 band 17's scale factor.
    dict(l=[0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194,
            232, 278, 332, 394, 464, 540, 576],
         s=[0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192]),  # 24
    # 16 kHz: dist10's loop.c:77 has typos (45 for 54, 248 for 284);
    # we use the correct IS 13818-3 Table B.2.a values -- the reference
    # cannot encode LSF at all (its psy exits, l3psy.c:174), so there
    # is no bitstream parity to preserve, and real decoders use the IS
    # values.
    dict(l=[0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
            238, 284, 336, 396, 464, 522, 576],
         s=[0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]),  # 16
    # MPEG-1 (version 1)
    dict(l=[0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
            162, 196, 238, 288, 342, 418, 576],
         s=[0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192]),  # 44.1
    dict(l=[0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
            156, 190, 230, 276, 330, 384, 576],
         s=[0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192]),  # 48
    dict(l=[0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
            194, 240, 296, 364, 448, 550, 576],
         s=[0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192]),  # 32
]


def sfband_index(version, sampling_frequency):
    return sampling_frequency + 3 * version


def sfb_long(version, sampling_frequency):
    return np.asarray(SFBAND[sfband_index(version, sampling_frequency)]["l"],
                      dtype=np.int32)


def sfb_short(version, sampling_frequency):
    return np.asarray(SFBAND[sfband_index(version, sampling_frequency)]["s"],
                      dtype=np.int32)


PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2],
                  dtype=np.int32)

SCFSI_BAND_LONG = np.array([0, 6, 11, 16, 21], dtype=np.int32)

SLEN1_TAB = np.array([0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4], dtype=np.int32)
SLEN2_TAB = np.array([0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3], dtype=np.int32)

# region0/region1 counts per number of scalefactor bands in the bigvalue
# region (loop.c subdv_table)
SUBDV_TABLE = np.array([
    [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 1], [1, 1], [1, 1],
    [1, 2], [2, 2], [2, 3], [2, 3], [3, 4], [3, 4], [3, 4], [4, 5],
    [4, 5], [4, 6], [5, 6], [5, 6], [5, 7], [6, 7], [6, 7],
], dtype=np.int32)

# MPEG-2 LSF scalefactor partitioning (IS 13818-3 2.4.3.2)
NR_OF_SFB_BLOCK = np.array([
    [[6, 5, 5, 5], [9, 9, 9, 9], [6, 9, 9, 9]],
    [[6, 5, 7, 3], [9, 9, 12, 6], [6, 9, 12, 6]],
    [[11, 10, 0, 0], [18, 18, 0, 0], [15, 18, 0, 0]],
    [[7, 7, 7, 0], [12, 12, 12, 0], [6, 15, 12, 0]],
    [[6, 6, 6, 3], [12, 9, 9, 6], [6, 12, 9, 6]],
    [[8, 8, 5, 0], [15, 12, 9, 0], [6, 18, 9, 0]],
], dtype=np.int32)

MAX_SFAC_TAB = np.array([
    [4, 4, 3, 3], [4, 4, 3, 0], [3, 2, 0, 0],
    [4, 5, 5, 0], [3, 3, 3, 0], [2, 2, 0, 0],
], dtype=np.int32)

LOG2_TAB = np.array([0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4], dtype=np.int32)

# Block types (l3psy.h:26-29)
NORM_TYPE, START_TYPE, SHORT_TYPE, STOP_TYPE = 0, 1, 2, 3

# Layer I/II scalefactor quantization steps (common.c:127-145)
_D = np.load(__file__.rsplit("/", 1)[0] + "/data/iso_tables.npz")
MULTIPLE = np.array([2.0 ** (1.0 - i / 3.0) for i in range(63)] + [1e-20])
# the reference hard-codes 14-digit decimals; regenerate them exactly:
MULTIPLE = np.round(MULTIPLE * 1e14) / 1e14
MULTIPLE[63] = 1e-20


def sideinfo_bits(version, nchannels, error_protection=False):
    """Header + side info length in bits (musicin.c:729-746)."""
    bits = 32
    if version == MPEG1:
        bits += 256 if nchannels == 2 else 136
    else:
        bits += 136 if nchannels == 2 else 72
    if error_protection:
        bits += 16
    return bits
