"""Layer I/II constant tables: bit-allocation tables, SNR ladder,
quantizer coefficients, joint-stereo bounds.

Sources (for parity checking against the upstream ISO reference):
  - alloc_0..4_data packed arrays: tables.c:1280-2076, unpacked by
    read_bit_alloc (common.c:236-266) into al_table[SBLIMIT][16] of
    {steps, bits, group, quant}; record j=0's `bits` field holds the
    width of the allocation index for that subband.
  - table choice rules: pick_table (common.c:288-317).
  - jsbound: js_bound (common.c:320-330).
  - snr[18] ladder and the Layer I in-place rearrangement:
    encode.c:777-780, 899-904.
  - quantizer a[17]/b[17] and the Layer I rearrangement:
    encode.c:1193-1226.
  - scfsi transmission pattern table: encode.c:635-639.
"""
import os

import numpy as np

_D = np.load(os.path.join(os.path.dirname(__file__), "data", "iso_tables.npz"))

SBLIMIT = 32
SCALE_BLOCK = 12
SCALE_RANGE = 64
NOISY_MIN_MNR = 0.0


def _unpack_alloc(flat):
    """read_bit_alloc (common.c:236-266): [sblimit, (sb, j, steps,
    bits, group, quant)*, 0xffffffff]."""
    flat = np.asarray(flat, np.int64)
    flat = np.where(flat == 0xFFFFFFFF, -1, flat)
    sblimit = int(flat[0])
    steps = np.zeros((SBLIMIT, 16), np.int64)
    bits = np.zeros((SBLIMIT, 16), np.int64)
    group = np.zeros((SBLIMIT, 16), np.int64)
    quant = np.zeros((SBLIMIT, 16), np.int64)
    p = 1
    while flat[p] != -1:
        sb, j, s, b, g, q = flat[p:p + 6]
        steps[sb, j] = s
        bits[sb, j] = b
        group[sb, j] = g
        quant[sb, j] = q
        p += 6
    return dict(sblimit=sblimit, steps=steps, bits=bits, group=group,
                quant=quant, nbal=bits[:, 0].copy())


ALLOC = [_unpack_alloc(_D[f"alloc_{i}"]) for i in range(5)]


def pick_table(version, layer, bitrate_index, sampling_frequency,
               nchannels, bitrate_kbps, sfreq_khz):
    """Allocation-table choice (common.c:288-317).  Returns
    (table_index, sblimit)."""
    if layer != 2:
        return None, SBLIMIT
    br_per_ch = bitrate_kbps // nchannels
    sfrq = int(sfreq_khz)          # the reference compares int kHz values
    if version == 1:               # MPEG-1
        if (sfrq == 48 and br_per_ch >= 56) or (56 <= br_per_ch <= 80):
            table = 0
        elif sfrq != 48 and br_per_ch >= 96:
            table = 1
        elif sfrq != 32 and br_per_ch <= 48:
            table = 2
        else:
            table = 3
    else:                          # MPEG-2 LSF
        table = 4
    return table, ALLOC[table]["sblimit"]


# js_bound (common.c:322-324): [layer-1][mode_ext]
JSB_TABLE = np.array([[4, 8, 12, 16], [4, 8, 12, 16], [0, 4, 8, 16]],
                     dtype=np.int64)

# snr[18] (encode.c:777-780); index = alloc `quant` (+1 above first step)
SNR_L2 = np.array([0.00, 7.00, 11.00, 16.00, 20.84, 25.28, 31.59, 37.75,
                   43.84, 49.89, 55.93, 61.96, 67.98, 74.01, 80.03, 86.05,
                   92.01, 98.01])

# Layer I rearrangement (encode.c:899-904): snr[2]=snr[3];
# snr[i]=snr[i+2] for 3<=i<16 (indexed directly by bit_alloc 0..14)
SNR_L1 = SNR_L2.copy()
SNR_L1[2] = SNR_L1[3]
for _i in range(3, 16):
    SNR_L1[_i] = SNR_L2[_i + 2]

# quantizer coefficients (encode.c:1193-1203); indexed by alloc `quant`
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

# Layer I rearrangement (encode.c:1222-1227): a[1]=a[2];
# a[i]=a[i+2] for 2<=i<15; indexed by bit_alloc-1
QUANT_A_L1 = QUANT_A.copy()
QUANT_B_L1 = QUANT_B.copy()
QUANT_A_L1[1] = QUANT_A[2]
QUANT_B_L1[1] = QUANT_B[2]
for _i in range(2, 15):
    QUANT_A_L1[_i] = QUANT_A[_i + 2]
    QUANT_B_L1[_i] = QUANT_B[_i + 2]

# scfsi per-class transmission pattern (encode.c:635-639)
SCFSI_PATTERN = np.array([
    [0x123, 0x122, 0x122, 0x133, 0x123],
    [0x113, 0x111, 0x111, 0x444, 0x113],
    [0x111, 0x111, 0x111, 0x333, 0x113],
    [0x222, 0x222, 0x222, 0x333, 0x123],
    [0x123, 0x122, 0x122, 0x133, 0x123]], dtype=np.int64)

SFS_PER_SCFSI = np.array([3, 2, 1, 2], dtype=np.int64)
