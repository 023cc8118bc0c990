"""Layer III rate/distortion iteration loop (loop.c), oracle form.

Faithful reimplementation of iteration_loop and its helpers, operating
on one granule-channel at a time (the reservoir makes granules
sequential; the TPU path in ``mp3tpu.models.layer3`` parallelizes this
via demand-first encoding + a host reservoir scan).

All semantic quirks of the reference are kept deliberately:
  - quantize() saturates at ix=2047 (pow_nint gallop search bound,
    pow_nint.h:15-49);
  - bin_search_StepSize bisects against max_bits (not huff_bits) and
    leaves the quantizer at the last midpoint probed (loop.c:2119-2140);
  - inner_loop then walks up from there, accepting the first step whose
    count fits (loop.c:569-606), so results are search-path dependent;
  - scalefac_scale and subblock_gain are never used (always 0);
  - preemphasis amplifies all long sfbs once all of sfb 17..20 are
    distorted (loop.c:1161-1213).
"""
import math
from dataclasses import dataclass, field

import numpy as np

from ..tables import dsp as TD
from ..tables import mpeg
from ..tables.huffman import ESC_TABLE_A, ESC_TABLE_B, FIRST_TABLE_FOR_MAX, HUFF


@dataclass
class GrInfo:
    part2_3_length: int = 0
    big_values: int = 0
    count1: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching_flag: int = 0
    block_type: int = 0
    mixed_block_flag: int = 0
    table_select: list = field(default_factory=lambda: [0, 0, 0])
    subblock_gain: list = field(default_factory=lambda: [0, 0, 0])
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0
    part2_length: int = 0
    sfb_lmax: int = 0
    sfb_smax: int = 0
    address1: int = 0
    address2: int = 0
    address3: int = 0
    quantizerStepSize: float = 0.0
    slen: list = field(default_factory=lambda: [0, 0, 0, 0])
    sfb_partition_table: int = 0  # row selector into NR_OF_SFB_BLOCK


def nint(x):
    return int(x - 0.5) if x < 0 else int(x + 0.5)


def gr_deco(gi):
    if gi.window_switching_flag and gi.block_type == 2:
        gi.sfb_lmax, gi.sfb_smax = (8, 3) if gi.mixed_block_flag else (0, 0)
    else:
        gi.sfb_lmax, gi.sfb_smax = 21, 12


def _seqsum(arr):
    """Sequential left-to-right sum (np.sum is pairwise/unrolled and
    rounds differently from the reference's scalar loops)."""
    s = 0.0
    for v in arr.tolist():
        s += v
    return s


def quantanf_init(xr):
    nz = xr != 0.0
    if not nz.any():
        return -70.0
    tpd = (xr[nz] * xr[nz]).tolist()
    sum1 = 0.0
    sum2 = 0.0
    for v in tpd:  # loop.c:379-387: both sums accumulate in one pass
        sum1 += math.log(v)
        sum2 += v
    if sum2 == 0.0:
        return -70.0
    sfm = math.exp(sum1 / 576.0) / (sum2 / 576.0)
    tp = nint(8.0 * math.log(sfm))
    if tp < -100.0:  # minlimit clamp (loop.c:377,392-393)
        tp = -100
    return tp - 70.0


def quantize(xr, qss):
    """ix = nint((|xr| / 2^(qss/4))^0.75 - 0.0946), capped at 2047."""
    step = math.pow(2.0, qss * 0.25)
    v = np.abs(xr) / step
    return np.searchsorted(TD.POW_NINT_BOUND, v, side="right").astype(np.int64)


def calc_runlen(ix, gi):
    """rzero/count1/big_values partition (loop.c:1488-1519)."""
    if gi.window_switching_flag and gi.block_type == 2:
        gi.count1 = 0
        gi.big_values = 288
        return
    i = 576
    while i > 1 and ix[i - 1] == 0 and ix[i - 2] == 0:
        i -= 2
    gi.count1 = 0
    while i > 3 and (abs(ix[i - 1]) <= 1 and abs(ix[i - 2]) <= 1
                     and abs(ix[i - 3]) <= 1 and abs(ix[i - 4]) <= 1):
        gi.count1 += 1
        i -= 4
    gi.big_values = i // 2


def count1_bitcount(ix, gi):
    i0 = gi.big_values * 2
    q = np.abs(ix[i0:i0 + 4 * gi.count1].reshape(-1, 4))
    if len(q) == 0:
        # C picks table 1 on the empty tie: sum0<sum1 is false (loop.c:1579)
        gi.count1table_select = 1
        return 0
    p = q[:, 0] + 2 * q[:, 1] + 4 * q[:, 2] + 8 * q[:, 3]
    signbits = np.sum(q != 0)
    s0 = int(np.sum(HUFF.count1_hlen(0)[p])) + signbits
    s1 = int(np.sum(HUFF.count1_hlen(1)[p])) + signbits
    if s0 < s1:
        gi.count1table_select = 0
        return int(s0)
    gi.count1table_select = 1
    return int(s1)


def subdivide(gi, sfb_l):
    if gi.big_values == 0:
        # region counts reset, but address1/2/3 keep their previous
        # (stale) values -- loop.c:1643-1647 does not clear them, and
        # bigv_tab_select/bigv_bitcount then count phantom region-0
        # bits that end up as stuffing.  Faithfully reproduced.
        gi.region0_count = gi.region1_count = 0
        return
    bvr = 2 * gi.big_values
    if gi.window_switching_flag == 0:
        scfb_anz = 0
        while sfb_l[scfb_anz] < bvr:
            scfb_anz += 1
        r0 = int(mpeg.SUBDV_TABLE[scfb_anz][0])
        idx = r0 + 1
        while r0 and sfb_l[idx] > bvr:
            r0 -= 1
            idx -= 1
        gi.region0_count = r0
        r1 = int(mpeg.SUBDV_TABLE[scfb_anz][1])
        idx = gi.region0_count + r1 + 2
        while r1 and sfb_l[idx] > bvr:
            r1 -= 1
            idx -= 1
        gi.region1_count = r1
        gi.address1 = int(sfb_l[gi.region0_count + 1])
        gi.address2 = int(sfb_l[gi.region0_count + gi.region1_count + 2])
        gi.address3 = bvr
    else:
        if gi.block_type == 2 and gi.mixed_block_flag == 0:
            gi.region0_count, gi.region1_count = 8, 36
            gi.address1, gi.address2, gi.address3 = 36, bvr, 0
        else:
            gi.region0_count, gi.region1_count = 7, 13
            gi.address1 = int(sfb_l[8])
            gi.address2, gi.address3 = bvr, 0


def count_bit(ix, start, end, table):
    """Bits for pairs ix[start:end] with a table (loop.c:172-225)."""
    if table == 0:
        return 0
    x = np.abs(ix[start:end:2])
    y = np.abs(ix[start + 1:end:2])
    xc = np.minimum(x, 15)
    yc = np.minimum(y, 15)
    bits = int(np.sum(HUFF.pair_bits[table, xc * 16 + yc]))
    if table > 15:
        # pair_bits already charges linbits for clipped 15s; count_bit
        # charges for >14, i.e. also for a true value of exactly 15 --
        # identical, since clip(15)==15.  Nothing further to add.
        pass
    return bits


def new_choose_table(ix, begin, end):
    seg = np.abs(ix[begin:end])
    if len(seg) == 0:
        return 0
    mx = int(seg.max())
    if mx == 0:
        return 0
    if mx < 15:
        c0 = int(FIRST_TABLE_FOR_MAX[mx])
        s0 = count_bit(ix, begin, end, c0)
        if c0 == 2:
            if count_bit(ix, begin, end, 3) <= s0:
                c0 = 3
        elif c0 == 5:
            if count_bit(ix, begin, end, 6) <= s0:
                c0 = 6
        elif c0 == 7:
            s1 = count_bit(ix, begin, end, 8)
            if s1 <= s0:
                c0, s0 = 8, s1
            if count_bit(ix, begin, end, 9) <= s0:
                c0 = 9
        elif c0 == 10:
            s1 = count_bit(ix, begin, end, 11)
            if s1 <= s0:
                c0, s0 = 11, s1
            if count_bit(ix, begin, end, 12) <= s0:
                c0 = 12
        elif c0 == 13:
            if count_bit(ix, begin, end, 15) <= s0:
                c0 = 15
        return c0
    ca = int(ESC_TABLE_A[mx - 15])
    cb = int(ESC_TABLE_B[mx - 15])
    sa = count_bit(ix, begin, end, ca)
    sb = count_bit(ix, begin, end, cb)
    return cb if sb < sa else ca


def choose_table(mx):
    """Short-block table choice (loop.c:1908-1943)."""
    if mx == 0:
        return 0
    if mx < 15:
        return int(FIRST_TABLE_FOR_MAX[mx])
    return int(ESC_TABLE_A[mx - 15])


def bigv_tab_select(ix, gi, sfb_s):
    gi.table_select = [0, 0, 0]
    if gi.window_switching_flag and gi.block_type == 2:
        ixs = ix.reshape(192, 3)
        max1 = max2 = 0
        for sfb in range(13):
            start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
            m = int(np.abs(ixs[start:end]).max()) if end > start else 0
            if start < 12:
                max1 = max(max1, m)
            else:
                max2 = max(max2, m)
        gi.table_select[0] = choose_table(max1)
        gi.table_select[1] = choose_table(max2)
    else:
        if gi.address1 > 0:
            gi.table_select[0] = new_choose_table(ix, 0, gi.address1)
        if gi.address2 > gi.address1:
            gi.table_select[1] = new_choose_table(ix, gi.address1, gi.address2)
        if gi.big_values * 2 > gi.address2:
            gi.table_select[2] = new_choose_table(ix, gi.address2, gi.big_values * 2)


def bigv_bitcount(ix, gi, sfb_s):
    if gi.window_switching_flag and gi.block_type == 2:
        bits = 0
        ixs = ix.reshape(192, 3)
        for sfb in range(13):
            start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
            t = gi.table_select[0] if start < 12 else gi.table_select[1]
            if t == 0 or end <= start:
                continue
            seg = np.abs(ixs[start:end])  # (n, 3)
            x = np.minimum(seg[0::2], 15)
            y = np.minimum(seg[1::2], 15)
            bits += int(np.sum(HUFF.pair_bits[t, x * 16 + y]))
        return bits
    bits = 0
    if gi.table_select[0]:
        bits += count_bit(ix, 0, gi.address1, gi.table_select[0])
    if gi.table_select[1]:
        bits += count_bit(ix, gi.address1, gi.address2, gi.table_select[1])
    if gi.table_select[2]:
        bits += count_bit(ix, gi.address2, gi.address3, gi.table_select[2])
    return bits


def count_bits(ix, gi, sfb_l, sfb_s):
    """bin_search helper (loop.c:2099-2113)."""
    calc_runlen(ix, gi)
    if int(np.abs(ix).max(initial=0)) > 8192:
        return 100000
    bits = count1_bitcount(ix, gi)
    subdivide(gi, sfb_l)
    bigv_tab_select(ix, gi, sfb_s)
    bits += bigv_bitcount(ix, gi, sfb_s)
    return bits


def bin_search_stepsize(desired_rate, start, xr, gi, sfb_l, sfb_s):
    """loop.c:2119-2140; mutates gi.quantizerStepSize, returns ix."""
    top = start
    bot = 200.0
    next_ = start
    ix = None
    while True:
        last = next_
        next_ = float(int((top + bot) / 2.0))  # aint truncation
        gi.quantizerStepSize = next_
        ix = quantize(xr, next_)
        bit = count_bits(ix, gi, sfb_l, sfb_s)
        if bit > desired_rate:
            top = next_
        else:
            bot = next_
        if not (bit != desired_rate and abs(last - next_) > 1.0):
            break
    return ix


def inner_loop(xr, max_bits, gi, sfb_l, sfb_s):
    assert max_bits >= 0
    gi.quantizerStepSize -= 1.0
    while True:
        while True:
            gi.quantizerStepSize += 1.0
            ix = quantize(xr, gi.quantizerStepSize)
            if int(np.abs(ix).max(initial=0)) <= 8191 + 14:
                break
        calc_runlen(ix, gi)
        bits = count1_bitcount(ix, gi)
        subdivide(gi, sfb_l)
        bigv_tab_select(ix, gi, sfb_s)
        bits += bigv_bitcount(ix, gi, sfb_s)
        if bits <= max_bits:
            break
    return ix, bits


def calc_xmin(xr, ratio_l, ratio_s, gi, sfb_l, sfb_s):
    """Allowed distortion per sfb (loop.c:1085-1119)."""
    xmin_l = np.zeros(21)
    xmin_s = np.zeros((12, 3))
    xrs = xr.reshape(192, 3)
    for sfb in range(gi.sfb_smax, 12):
        start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
        bw = end - start
        prod = xrs[start:end] * xrs[start:end]
        en3 = np.zeros(3)
        for l in range(end - start):  # sequential, loop.c:1103-1104
            en3 += prod[l]
        xmin_s[sfb] = ratio_s[sfb] * en3 / bw
    for sfb in range(gi.sfb_lmax):
        start, end = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
        bw = end - start
        en = _seqsum(xr[start:end] * xr[start:end])
        xmin_l[sfb] = ratio_l[sfb] * en / bw
    return xmin_l, xmin_s


def calc_noise(xr, ix, gi, sfb_l, sfb_s):
    """Quantization distortion per sfb (loop.c:1007-1070)."""
    xfsf_l = np.zeros(21)
    xfsf_s = np.zeros((3, 12))
    step = math.pow(2.0, gi.quantizerStepSize * 0.25)
    for sfb in range(gi.sfb_lmax):
        start, end = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
        bw = end - start
        t = np.abs(xr[start:end]) - TD.POW_4_3[ix[start:end]] * step
        xfsf_l[sfb] = _seqsum(t * t) / bw
    xrs = xr.reshape(192, 3)
    ixs = ix.reshape(192, 3)
    for i in range(3):
        for sfb in range(gi.sfb_smax, 12):
            start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
            bw = end - start
            t = np.abs(xrs[start:end, i]) - TD.POW_4_3[ixs[start:end, i]] * step
            xfsf_s[i, sfb] = _seqsum(t * t) / bw
    return xfsf_l, xfsf_s


def part2_length(scalefac_l, scalefac_s, gi, scfsi, gr, version):
    if version == mpeg.MPEG1:
        slen1 = int(mpeg.SLEN1_TAB[gi.scalefac_compress])
        slen2 = int(mpeg.SLEN2_TAB[gi.scalefac_compress])
        bits = 0
        if gi.window_switching_flag == 1 and gi.block_type == 2:
            if gi.mixed_block_flag:
                bits += 17 * slen1 + 18 * slen2
            else:
                bits += 18 * slen1 + 18 * slen2
        else:
            if gr == 0 or scfsi[0] == 0:
                bits += 6 * slen1
            if gr == 0 or scfsi[1] == 0:
                bits += 5 * slen1
            if gr == 0 or scfsi[2] == 0:
                bits += 5 * slen2
            if gr == 0 or scfsi[3] == 0:
                bits += 5 * slen2
        return bits
    # MPEG-2 LSF
    row = mpeg.NR_OF_SFB_BLOCK[gi.sfb_partition_table // 3][gi.sfb_partition_table % 3]
    return int(sum(gi.slen[p] * int(row[p]) for p in range(4)))


def scale_bitcount(scalefac_l, scalefac_s, gi):
    """MPEG-1 scalefac_compress selection (loop.c:792-856)."""
    max1 = max2 = 0
    if gi.window_switching_flag and gi.block_type == 2:
        if gi.mixed_block_flag == 0:
            max1 = int(scalefac_s[:6].max())
            max2 = int(scalefac_s[6:12].max())
        else:
            max1 = max(int(scalefac_l[:8].max()), int(scalefac_s[3:6].max()))
            max2 = int(scalefac_s[6:12].max())
    else:
        max1 = int(scalefac_l[:11].max())
        max2 = int(scalefac_l[11:21].max())
    pow2 = [1, 2, 4, 8, 16]
    for k in range(16):
        if max1 < pow2[mpeg.SLEN1_TAB[k]] and max2 < pow2[mpeg.SLEN2_TAB[k]]:
            gi.scalefac_compress = k
            return 0
    return 2


def scale_bitcount_lsf(scalefac_l, scalefac_s, gi):
    """MPEG-2 LSF slen selection (loop.c:871-993)."""
    table_number = 2 if gi.preflag else 0
    max_sfac = [0, 0, 0, 0]
    if gi.window_switching_flag and gi.block_type == 2:
        row_in_table = 1 if gi.mixed_block_flag == 0 else 2
        part = mpeg.NR_OF_SFB_BLOCK[table_number][row_in_table]
        sfb = 0
        for p in range(4):
            for _ in range(int(part[p]) // 3):
                for w in range(3):
                    max_sfac[p] = max(max_sfac[p], int(scalefac_s[sfb, w]))
                sfb += 1
    else:
        row_in_table = 0
        part = mpeg.NR_OF_SFB_BLOCK[table_number][row_in_table]
        sfb = 0
        for p in range(4):
            for _ in range(int(part[p])):
                max_sfac[p] = max(max_sfac[p], int(scalefac_l[sfb]))
                sfb += 1
    over = sum(max_sfac[p] > int(mpeg.MAX_SFAC_TAB[table_number][p]) for p in range(4))
    if not over:
        gi.sfb_partition_table = table_number * 3 + row_in_table
        for p in range(4):
            gi.slen[p] = int(mpeg.LOG2_TAB[max_sfac[p]])
        s1, s2, s3, s4 = gi.slen
        if table_number == 0:
            gi.scalefac_compress = (((s1 * 5) + s2) << 4) + (s3 << 2) + s4
        elif table_number == 1:
            gi.scalefac_compress = 400 + (((s1 * 5) + s2) << 2) + s3
        else:
            gi.scalefac_compress = 500 + (s1 * 3) + s2
    return over


def loop_break(scalefac_l, scalefac_s, gi):
    if (scalefac_l[:gi.sfb_lmax] == 0).any():
        return 0
    if (scalefac_s[gi.sfb_smax:12] == 0).any():
        return 0
    return 1


def preemphasis(xr, xfsf_l, xmin_l, gi, gr, scfsi, gr0_preflag, sfb_l):
    if gr == 1 and any(scfsi):
        gi.preflag = gr0_preflag
        return
    if gi.block_type != 2 and gi.preflag == 0:
        over = sum(xfsf_l[sfb] > xmin_l[sfb] for sfb in range(17, 21))
        if over == 4:
            gi.preflag = 1
            ifqstep = math.sqrt(2.0) if gi.scalefac_scale == 0 else \
                math.pow(2.0, 0.5 * (1.0 + gi.scalefac_scale))
            for sfb in range(gi.sfb_lmax):
                # libm pow for bit-identity (loop.c:1205,1209)
                xmin_l[sfb] *= math.pow(ifqstep, 2.0 * float(mpeg.PRETAB[sfb]))
                start, end = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
                xr[start:end] *= math.pow(ifqstep, float(mpeg.PRETAB[sfb]))


def amp_scalefac_bands(xr, xfsf_l, xfsf_s, xmin_l, xmin_s, scalefac_l,
                       scalefac_s, gi, gr0, gr, scfsi, iteration,
                       scalefac_l_gr0, sfb_l, sfb_s):
    ifqstep = np.sqrt(2.0) if gi.scalefac_scale == 0 else \
        2.0 ** (0.5 * (1.0 + gi.scalefac_scale))
    copy_sf = prevent_sf = False
    if gr == 1 and any(scfsi):
        if gr0.scalefac_scale == 0:
            ifqstep = np.sqrt(2.0)
        else:
            ifqstep = 2.0 ** (0.5 * (1.0 + gr0.scalefac_scale))
        if iteration == 1:
            copy_sf = True
        else:
            prevent_sf = True
    ifqstep2 = ifqstep * ifqstep
    over = 0
    scfsi_band = 0
    for sfb in range(gi.sfb_lmax):
        if copy_sf or prevent_sf:
            if sfb == mpeg.SCFSI_BAND_LONG[scfsi_band + 1]:
                scfsi_band += 1
            if scfsi[scfsi_band]:
                if copy_sf:
                    scalefac_l[sfb] = scalefac_l_gr0[sfb]
                continue
        if xfsf_l[sfb] > xmin_l[sfb]:
            over += 1
            xmin_l[sfb] *= ifqstep2
            scalefac_l[sfb] += 1
            start, end = int(sfb_l[sfb]), int(sfb_l[sfb + 1])
            xr[start:end] *= ifqstep
    xrs = xr.reshape(192, 3)
    for i in range(3):
        for sfb in range(gi.sfb_smax, 12):
            if xfsf_s[i, sfb] > xmin_s[sfb, i]:
                over += 1
                xmin_s[sfb, i] *= ifqstep2
                scalefac_s[sfb, i] += 1
                start, end = int(sfb_s[sfb]), int(sfb_s[sfb + 1])
                xrs[start:end, i] *= ifqstep
    return over


def outer_loop(xr, max_bits, xmin_l, xmin_s, gi, gr0, gr, scfsi,
               scalefac_l, scalefac_s, scalefac_l_gr0, version, sfb_l, sfb_s):
    """loop.c:415-558; xr is the working copy and is amplified in place."""
    iteration = 0
    bits = 0
    ix = np.zeros(576, np.int64)
    while True:
        iteration += 1
        gi.part2_length = part2_length(scalefac_l, scalefac_s, gi, scfsi, gr, version)
        huff_bits = max_bits - gi.part2_length
        if iteration == 1:
            bin_search_stepsize(max_bits, gi.quantizerStepSize, xr, gi, sfb_l, sfb_s)
        ix, bits = inner_loop(xr, huff_bits, gi, sfb_l, sfb_s)
        xfsf_l, xfsf_s = calc_noise(xr, ix, gi, sfb_l, sfb_s)

        scalesave_l = scalefac_l.copy()
        scalesave_s = scalefac_s.copy()
        save_preflag = gi.preflag
        save_compress = gi.scalefac_compress

        preemphasis(xr, xfsf_l, xmin_l, gi, gr, scfsi, gr0.preflag, sfb_l)
        over = amp_scalefac_bands(xr, xfsf_l, xfsf_s, xmin_l, xmin_s,
                                  scalefac_l, scalefac_s, gi, gr0, gr, scfsi,
                                  iteration, scalefac_l_gr0, sfb_l, sfb_s)
        status = loop_break(scalefac_l, scalefac_s, gi)
        if status == 0:
            if version == mpeg.MPEG1:
                status = scale_bitcount(scalefac_l, scalefac_s, gi)
            else:
                status = scale_bitcount_lsf(scalefac_l, scalefac_s, gi)
        if not (status == 0 and over > 0):
            break

    gi.preflag = save_preflag
    gi.scalefac_compress = save_compress
    scalefac_l[:] = scalesave_l
    scalefac_s[:] = scalesave_s
    gi.part2_length = part2_length(scalefac_l, scalefac_s, gi, scfsi, gr, version)
    gi.part2_3_length = gi.part2_length + bits
    return ix
