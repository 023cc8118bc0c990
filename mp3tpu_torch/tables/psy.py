"""Psychoacoustic model 2 partition tables (Layer III flavour).

Parses the flat ``psy_data`` array exactly the way the reference's
``L3para_read`` does (l3psy.c:770-994): six per-sample-rate blocks of
long-partition rows, short-partition rows, and the partition->scalefactor
band conversion tables, followed by spreading-function computation from
the partition bark values (including the reference's asymmetric 1.5/3.0
slopes and -60 dB cutoff).

Also reproduces two deliberate reference quirks needed for parity:
  - at 44.1 kHz the long-block spreading convolution is restricted to the
    sparse index bounds ``s3ind`` (l3psy.c:996-1060);
  - the short-block path reuses the *long* spreading matrix and norm
    (l3psy.c:707-712).
"""
import os
from functools import lru_cache

import numpy as np

CBANDS = 63
CBANDS_S = 42
HBLKSIZE = 513
HBLKSIZE_S = 129
SBMAX_L = 21
SBMAX_S = 12

_LN_TO_LOG10 = 0.2302585093

_D = np.load(os.path.join(os.path.dirname(__file__), "data", "iso_tables.npz"))
PSY_DATA = _D["psy_data"]

# Sparse spreading bounds used for the 44.1 kHz long path (l3psy.c:996-1060).
S3IND = np.array([
    (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 9), (0, 10),
    (0, 11), (0, 12), (1, 14), (1, 14), (2, 15), (3, 15), (5, 16), (6, 17),
    (7, 19), (9, 20), (10, 21), (11, 22), (12, 23), (14, 24), (15, 25),
    (15, 27), (16, 28), (16, 28), (17, 29), (18, 30), (19, 31), (19, 32),
    (20, 34), (21, 35), (22, 36), (22, 36), (23, 37), (24, 38), (25, 39),
    (26, 41), (27, 42), (28, 43), (29, 44), (30, 45), (31, 46), (32, 47),
    (33, 48), (34, 49), (35, 50), (36, 51), (37, 52), (37, 53), (38, 54),
    (39, 55), (40, 56), (41, 57), (42, 58), (43, 59), (44, 60), (45, 61),
    (46, 62), (47, 62), (48, 62), (48, 62),
], dtype=np.int32)


def _spreading(bval, nmax):
    """Spreading matrix per l3psy.c:820-851 (same formula for short :893-920)."""
    s3 = np.zeros((CBANDS, CBANDS))
    for i in range(nmax):
        for j in range(nmax):
            if j >= i:
                tempx = (bval[i] - bval[j]) * 3.0
            else:
                tempx = (bval[i] - bval[j]) * 1.5
            if 0.5 <= tempx <= 2.5:
                t = tempx - 0.5
                x = 8.0 * (t * t - 2.0 * t)
            else:
                x = 0.0
            tempx += 0.474
            tempy = 15.811389 + 7.5 * tempx - 17.5 * np.sqrt(1.0 + tempx * tempx)
            if tempy > -60.0:
                s3[i, j] = np.exp((x + tempy) * _LN_TO_LOG10)
    return s3


def _gen_sfb_conv(partition, numlines, sfb_edges, nsb, scale):
    """Partition -> scalefactor-band conversion tables (bu/bo/w1/w2).

    Reverse-engineered from the tabulated psy_data conversion rows: an
    sfb edge at MDCT line m sits at FFT bin position m*scale + 0.5
    (bin-center convention; scale = 1024/1152 long, 256/384 short);
    the partition containing that position is split between adjacent
    sfbs with complementary weights (w2[sb] + w1[sb+1] == 1).  The
    generated values match the shipped dist10 tables for the three
    MPEG-1 rates to within one boundary bin.
    """
    starts = np.concatenate([[0.0], np.cumsum(numlines)])
    bu = np.zeros(nsb, np.int32)
    bo = np.zeros(nsb, np.int32)
    w1 = np.zeros(nsb)
    w2 = np.zeros(nsb)
    prev_bo, prev_w2, first = 0, 0.0, True
    nmax = int(np.max(partition))
    for sb in range(nsb):
        e = float(sfb_edges[sb + 1]) * scale + 0.5
        bu[sb] = prev_bo
        w1[sb] = 1.0 if first else 1.0 - prev_w2
        first = False
        b = int(np.searchsorted(starts, e, side="right")) - 1
        b = min(b, nmax)
        while numlines[b] == 0 and b > 0:
            b -= 1
        w = min((e - starts[b]) / max(numlines[b], 1), 1.0)
        bo[sb] = b
        w2[sb] = w
        prev_bo, prev_w2 = b, w
    return bu, bo, w1, w2


LSF_RATES = (22050.0, 24000.0, 16000.0)


def _lsf_params(sfreq_hz):
    """Model-2 tables for the MPEG-2 LSF rates (16/22.05/24 kHz).

    The reference ships no psy tables for these rates -- its psy model
    exits on them (l3psy.c:174), so MPEG-2 LSF encoding is dead code in
    the reference despite the framing/rate-loop support.  Each LSF rate
    is exactly half an MPEG-1 rate, so the FFT line at index i sits at
    the frequency of parent line i/2: the partition map, bark values,
    minval and spreading carry over directly, with numlines recounted
    on the denser grid and the absolute thresholds scaled by the line
    count (threshold mass per partition is proportional to the number
    of lines it spans).  The partition->sfb conversion is generated for
    the LSF scalefactor-band edges with the same rule the dist10 tables
    follow (_gen_sfb_conv).
    """
    from . import mpeg

    parent = psy_params_for_sfreq(2.0 * sfreq_hz)
    idx = {22050.0: 0, 24000.0: 1, 16000.0: 2}[float(sfreq_hz)]
    out = {}

    def halve(partition_parent, nbins):
        part = partition_parent[np.arange(nbins) // 2].astype(np.int32)
        nl = np.bincount(part, minlength=CBANDS).astype(np.int32)
        # partitions past the new nyquist keep zero lines
        return part, nl

    partition_l, numlines = halve(parent["partition_l"], HBLKSIZE)
    cbmax_l = int(partition_l.max()) + 1
    qthr_l = np.where(parent["numlines"] > 0,
                      parent["qthr_l"] * numlines /
                      np.maximum(parent["numlines"], 1), 0.0)
    s3_l = _spreading(parent["bval_l"], cbmax_l)

    partition_s, numlines_s = halve(parent["partition_s"], HBLKSIZE_S)
    cbmax_s = int(partition_s.max()) + 1
    qthr_s = np.where(parent["numlines_s"] > 0,
                      parent["qthr_s"] * numlines_s /
                      np.maximum(parent["numlines_s"], 1), 0.0)

    sfb_l = mpeg.sfb_long(mpeg.MPEG2_LSF, idx)
    sfb_s = mpeg.sfb_short(mpeg.MPEG2_LSF, idx)
    bu_l, bo_l, w1_l, w2_l = _gen_sfb_conv(
        partition_l, numlines, sfb_l, SBMAX_L, 1024.0 / 1152.0)
    bu_s, bo_s, w1_s, w2_s = _gen_sfb_conv(
        partition_s, numlines_s, sfb_s, SBMAX_S, 256.0 / 384.0)

    numlines_pe = numlines.copy()
    numlines_pe[:cbmax_s] = numlines_s[:cbmax_s]

    out.update(
        sfreq=sfreq_hz, cbmax_l=cbmax_l, cbmax_s=cbmax_s,
        numlines=numlines, numlines_pe=numlines_pe,
        minval=parent["minval"].copy(), qthr_l=qthr_l,
        norm_l=parent["norm_l"].copy(), bval_l=parent["bval_l"].copy(),
        partition_l=partition_l, s3_l=s3_l,
        s3_mask=np.ones((CBANDS, CBANDS)),
        numlines_s=numlines_s, qthr_s=qthr_s,
        norm_s=parent["norm_s"].copy(), snr_s=parent["snr_s"].copy(),
        bval_s=parent["bval_s"].copy(), partition_s=partition_s,
        s3_s=_spreading(parent["bval_s"], cbmax_s),
        cbw_l=(bo_l - bu_l).astype(np.int32), bu_l=bu_l, bo_l=bo_l,
        w1_l=w1_l, w2_l=w2_l,
        cbw_s=(bo_s - bu_s).astype(np.int32), bu_s=bu_s, bo_s=bo_s,
        w1_s=w1_s, w2_s=w2_s,
    )
    return out


@lru_cache(maxsize=None)
def psy_params_for_sfreq(sfreq_hz):
    """All Layer III model-2 tables for one sample rate (Hz, e.g. 44100).

    Returns a dict of numpy arrays sized to the fixed CBANDS/CBANDS_S
    dimensions with zero padding, mirroring the reference's static
    buffers.  The MPEG-2 LSF rates (16/22.05/24 kHz) are derived from
    their doubled MPEG-1 parents (_lsf_params) -- the reference has no
    tables for them at all.
    """
    if float(sfreq_hz) in LSF_RATES:
        return _lsf_params(float(sfreq_hz))
    p = PSY_DATA
    pos = 0
    out = {}

    # --- long partition block (l3psy.c:784-811)
    numlines = np.zeros(CBANDS, np.int32)
    minval = np.zeros(CBANDS)
    qthr_l = np.zeros(CBANDS)
    norm_l = np.zeros(CBANDS)
    bval_l = np.zeros(CBANDS)
    partition_l = np.zeros(HBLKSIZE, np.int32)
    cbmax_l = 0
    for _ in range(6):
        freq = p[pos]; n = int(p[pos + 1]) + 1; pos += 2
        if freq == sfreq_hz:
            cbmax_l = n
            k2 = 0
            for i in range(n):
                row = p[pos:pos + 6]; pos += 6
                assert int(row[0]) == i
                numlines[i] = int(row[1])
                minval[i], qthr_l[i], norm_l[i], bval_l[i] = row[2:6]
                partition_l[k2:k2 + numlines[i]] = i
                k2 += numlines[i]
            # lines beyond k2 keep partition 0, as in the C static array
        else:
            pos += n * 6

    s3_l = _spreading(bval_l, cbmax_l)

    # --- short partition block (l3psy.c:856-883)
    numlines_s = np.zeros(CBANDS, np.int32)
    qthr_s = np.zeros(CBANDS)
    norm_s = np.zeros(CBANDS)
    snr_s = np.zeros(CBANDS)
    bval_s = np.zeros(CBANDS)
    partition_s = np.zeros(HBLKSIZE_S, np.int32)
    cbmax_s = 0
    for _ in range(6):
        freq = p[pos]; n = int(p[pos + 1]) + 1; pos += 2
        if freq == sfreq_hz:
            cbmax_s = n
            k2 = 0
            for i in range(n):
                row = p[pos:pos + 6]; pos += 6
                assert int(row[0]) == i
                numlines_s[i] = int(row[1])
                qthr_s[i], norm_s[i], snr_s[i], bval_s[i] = row[2:6]
                partition_s[k2:k2 + numlines_s[i]] = i
                k2 += numlines_s[i]
        else:
            pos += n * 6

    s3_s = _spreading(bval_s, cbmax_s)  # computed but unused by the
    # reference short path, which reuses s3_l (l3psy.c:708); kept for the
    # future "fixed psychoacoustics" quality mode.

    # --- long partition -> sfb conversion (l3psy.c:927-957)
    cbw_l = np.zeros(SBMAX_L, np.int32); bu_l = np.zeros(SBMAX_L, np.int32)
    bo_l = np.zeros(SBMAX_L, np.int32)
    w1_l = np.zeros(SBMAX_L); w2_l = np.zeros(SBMAX_L)
    for _ in range(6):
        freq = p[pos]; n = int(p[pos + 1]) + 1; pos += 2
        if freq == sfreq_hz:
            for i in range(n):
                row = p[pos:pos + 6]; pos += 6
                assert int(row[0]) == i
                cbw_l[i], bu_l[i], bo_l[i] = int(row[1]), int(row[2]), int(row[3])
                w1_l[i], w2_l[i] = row[4], row[5]
        else:
            pos += n * 6

    # --- short partition -> sfb conversion (l3psy.c:962-992)
    cbw_s = np.zeros(SBMAX_S, np.int32); bu_s = np.zeros(SBMAX_S, np.int32)
    bo_s = np.zeros(SBMAX_S, np.int32)
    w1_s = np.zeros(SBMAX_S); w2_s = np.zeros(SBMAX_S)
    for _ in range(6):
        freq = p[pos]; n = int(p[pos + 1]) + 1; pos += 2
        if freq == sfreq_hz:
            for i in range(n):
                row = p[pos:pos + 6]; pos += 6
                assert int(row[0]) == i
                cbw_s[i], bu_s[i], bo_s[i] = int(row[1]), int(row[2]), int(row[3])
                w1_s[i], w2_s[i] = row[4], row[5]
        else:
            pos += n * 6

    assert cbmax_l > 0 and cbmax_s > 0, f"unsupported sample rate {sfreq_hz}"

    # Dense mask for the 44.1 kHz sparse convolution: weight is s3_l
    # within the s3ind bounds, zero outside.
    s3_mask = np.zeros((CBANDS, CBANDS))
    for b in range(CBANDS):
        lo, hi = S3IND[b]
        s3_mask[b, lo:hi + 1] = 1.0

    # L3para_read reads the short-partition rows into the *same*
    # numlines array (l3psy.c:868), clobbering long entries < cbmax_s.
    # pe (l3psy.c:639-645) therefore uses this mixture.
    numlines_pe = numlines.copy()
    numlines_pe[:cbmax_s] = numlines_s[:cbmax_s]

    out.update(
        sfreq=sfreq_hz, cbmax_l=cbmax_l, cbmax_s=cbmax_s,
        numlines=numlines, numlines_pe=numlines_pe, minval=minval, qthr_l=qthr_l, norm_l=norm_l,
        bval_l=bval_l, partition_l=partition_l, s3_l=s3_l, s3_mask=s3_mask,
        numlines_s=numlines_s, qthr_s=qthr_s, norm_s=norm_s, snr_s=snr_s,
        bval_s=bval_s, partition_s=partition_s, s3_s=s3_s,
        cbw_l=cbw_l, bu_l=bu_l, bo_l=bo_l, w1_l=w1_l, w2_l=w2_l,
        cbw_s=cbw_s, bu_s=bu_s, bo_s=bo_s, w1_s=w1_s, w2_s=w2_s,
    )
    return out
