"""Layer I/II bit allocation, vectorized over frames.

The reference's greedy min-MNR water-filling (encode.c:983-1173) has
no cross-frame state, so all frames advance in lockstep: each
iteration performs one greedy step per frame (argmin over the 64
(subband, channel) lanes + masked scatter updates).  Results are
bit-identical to the sequential oracle (mp3tpu/numpy_ref/layer12.py)
including argmin tie-breaking (first index in the reference's
sb-outer/ch-inner scan order).

The joint-stereo mode decision (encode.c:888-955) is vectorized by
evaluating bits_for_nonoise for all five jsbound candidates at once:
the two-stage per-subband search equals max of the per-channel minimal
allocations (both searches walk the same monotone SNR ladder).
"""
import numpy as np

from ..tables import layer12 as T

INF = np.float64(1e30)


def _snr_ladder(layer, table):
    """per-subband (32, 16) SNR after allocation ba, and the
    incremental sample-bit cost of stepping ba-1 -> ba."""
    if layer == 1:
        snr_after = np.tile(T.SNR_L1[:16], (32, 1))
        cost = np.zeros((32, 16))
        cost[:, 1:] = 12.0 * np.arange(1, 16)[None, :] + 12.0
        maxba = np.full(32, 14)
        nbal = np.full(32, 4)
    else:
        alloc = T.ALLOC[table]
        snr_after = T.SNR_L2[np.minimum(alloc["quant"] + 1, 17)]
        cost = 12.0 * alloc["group"] * alloc["bits"]   # (32, 16) total
        maxba = (1 << alloc["nbal"]) - 1
        nbal = alloc["nbal"]
    return snr_after, cost, maxba, nbal


def bits_for_nonoise(smr, scfsi, jsbound, layer, table, nch,
                     error_protection):
    """Vectorized *_bits_for_nonoise (encode.c:782-860).

    smr (F, 2, 32); scfsi (F, 2, 32) or None; jsbound (F,) int.
    Returns (F,) required bits.
    """
    F = smr.shape[0]
    snr_after, cost, maxba, nbal = _snr_ladder(layer, table)
    sblimit = 32 if layer == 1 else T.ALLOC[table]["sblimit"]
    sb = np.arange(32)
    js = sb[None, :] >= jsbound[:, None]          # (F, 32)
    in_range = sb[None, :] < sblimit

    # minimal ba per (f, ch, sb): search the snr ladder used by the
    # reference's break condition.  Layer 1 uses snr[k] for step k+1
    # with bound k<14; layer 2 uses snr[quant[ba]+(ba>0)] bound
    # ba<maxAlloc-1.
    if layer == 1:
        ladder = np.tile(T.SNR_L1[:14], (32, 1))   # condition at k
        bound = np.full(32, 14)
    else:
        alloc = T.ALLOC[table]
        idx = alloc["quant"] + (np.arange(16)[None, :] > 0)
        ladder = T.SNR_L2[np.minimum(idx, 17)]     # (32, 16) at ba
        ladder[:, 0] = T.SNR_L2[alloc["quant"][:, 0]]
        bound = maxba - 1
    # min k with ladder[sb][k] >= smr, else bound
    lad = ladder.copy()
    for s in range(32):
        lad[s, bound[s]:] = INF
    # monotone ladders -> searchsorted per subband
    k = np.empty((F, 2, 32), np.int64)
    for s in range(32):
        b = int(bound[s])
        if b <= 0:
            k[:, :, s] = 0
            continue
        k[:, :, s] = np.searchsorted(ladder[s, :b], smr[:, :, s],
                                     side="left")
    # js: continue search with the other channel from k -> max
    k_eff = k.copy()
    if nch == 2:
        k_js = np.maximum(k[:, 0], k[:, 1])       # (F, 32)
        k_eff[:, 0] = np.where(js, k_js, k[:, 0])

    if layer == 1:
        per = np.where(k_eff[:, :, :] > 0,
                       (k_eff + 1) * 12
                       + 6 * np.where(js, nch, 1)[:, None, :], 0)
        chan_mask = np.ones((F, 2, 32), bool)
        chan_mask[:, 1] = ~js if nch == 2 else False
        if nch == 1:
            chan_mask[:, 1] = False
        req = 32 + 4 * (jsbound * nch + (32 - jsbound))
        req = req + (per * chan_mask).sum(axis=(1, 2))
        return req
    # layer 2
    sfs = T.SFS_PER_SCFSI[scfsi]                  # (F, 2, 32)
    smp = np.zeros((F, 2, 32))
    cols = np.arange(32)
    smp_tab = 12.0 * T.ALLOC[table]["group"] * T.ALLOC[table]["bits"]
    smp = smp_tab[cols[None, None, :], k_eff]
    sel = np.full((F, 2, 32), 2.0)
    sc = 6.0 * sfs
    if nch == 2:
        sel = sel + np.where(js, 2.0, 0.0)[:, None, :]
        sc = sc + np.where(js[:, None, :],
                           6.0 * sfs[:, ::-1], 0.0)
    per = np.where(k_eff > 0, smp + sel + sc, 0.0)
    chan_mask = np.ones((F, 2, 32), bool)
    chan_mask &= in_range[:, None, :]
    if nch == 2:
        chan_mask[:, 1] &= ~js
    else:
        chan_mask[:, 1] = False
    bbal = (nbal[None, :] * in_range
            * np.where(js, 1, nch)).sum(axis=1)
    req = (32 + bbal + (16 if error_protection else 0)
           + (per * chan_mask).sum(axis=(1, 2)))
    return req


def joint_mode(smr, scfsi, adb, layer, table, nch, error_protection):
    """encode.c:888-955: per-frame (mode_is_js, mode_ext, jsbound)."""
    F = smr.shape[0]
    sblimit = 32 if layer == 1 else T.ALLOC[table]["sblimit"]
    full = np.full(F, sblimit if layer == 2 else 32)
    req = bits_for_nonoise(smr, scfsi, full, layer, table, nch,
                           error_protection)
    needs_js = req > adb
    mode_ext = np.zeros(F, np.int64)
    jsbound = full.copy()
    active = needs_js.copy()
    for ext in (3, 2, 1, 0):
        if not active.any():
            break
        jb = int(T.JSB_TABLE[layer - 1][ext])
        cand = np.full(F, jb)
        req = bits_for_nonoise(smr, scfsi, cand, layer, table, nch,
                               error_protection)
        mode_ext[active] = ext
        jsbound[active] = jb
        active = active & (req > adb) & (ext > 0)
    return needs_js, mode_ext, jsbound


def greedy_allocation(smr, scfsi, adb, jsbound, layer, table, nch,
                      error_protection):
    """Vectorized exact greedy (encode.c:983-1173).

    smr (F, 2, 32) (duplicate channel 0 for mono); scfsi (F, 2, 32) or
    None (layer 1); adb (F,); jsbound (F,).
    Returns (bit_alloc (F, 2, 32), adb_left (F,)).
    """
    F = smr.shape[0]
    snr_after, cost, maxba, nbal = _snr_ladder(layer, table)
    sblimit = 32 if layer == 1 else T.ALLOC[table]["sblimit"]
    sb = np.arange(32)
    js = sb[None, :] >= jsbound[:, None]

    if layer == 1:
        bbal = 4 * (jsbound * nch + (32 - jsbound))
    else:
        in_range = sb < sblimit
        bbal = ((nbal * in_range)[None, :]
                * np.where(js, 1, nch)).sum(axis=1)
    ad = adb - bbal - (16 if error_protection else 0) - 32

    mnr = -smr.astype(np.float64).copy()          # snr[0] = 0
    used = np.zeros((F, 2, 32), np.int8)
    ba = np.zeros((F, 2, 32), np.int64)
    bspl = np.zeros(F)
    bscf = np.zeros(F)
    bsel = np.zeros(F)
    fidx = np.arange(F)
    if scfsi is not None:
        scale6 = 6.0 * T.SFS_PER_SCFSI[scfsi]     # (F, 2, 32)

    # candidate mask template
    lane_ok = np.ones((2, 32), bool)
    lane_ok[:, sblimit:] = False
    if nch == 1:
        lane_ok[1] = False

    while True:
        cand = np.where((used != 2) & lane_ok[None], mnr, INF)
        # reference scan order: sb outer, ch inner -> (F, 32, 2)
        flat = cand.transpose(0, 2, 1).reshape(F, 64)
        pick = flat.argmin(axis=1)
        # layer 1 initializes the running min to mnr[0][0]+1
        # (encode.c:1017), so lanes at or above that are never found
        limit = mnr[:, 0, 0] + 1.0 if layer == 1 else np.full(F, INF)
        has = flat[fidx, pick] < np.minimum(limit, INF)
        if not has.any():
            break
        psb = pick // 2
        pch = pick % 2

        cur = ba[fidx, pch, psb]
        if layer == 1:
            inc = np.where(used[fidx, pch, psb] > 0, 12.0, 24.0)
            scale = np.where(used[fidx, pch, psb] > 0, 0.0, 6.0)
            scale = scale * np.where(js[fidx, psb], nch, 1)
            seli = np.zeros(F)
        else:
            # done frames pick an arbitrary (all-INF) lane whose ba may
            # be maxed; clamp the gather (their updates are masked off)
            nxt = cost[psb, np.minimum(cur + 1, 15)]
            inc = nxt - np.where(used[fidx, pch, psb] > 0,
                                 cost[psb, cur], 0.0)
            first = used[fidx, pch, psb] == 0
            seli = np.where(first, 2.0, 0.0)
            scale = np.where(first, scale6[fidx, pch, psb], 0.0)
            if nch == 2:
                extra = js[fidx, psb] & first
                seli = seli + np.where(extra, 2.0, 0.0)
                scale = scale + np.where(
                    extra, scale6[fidx, 1 - pch, psb], 0.0)
        fits = ad >= bspl + bscf + bsel + seli + scale + inc
        take = has & fits
        freeze = has & ~fits

        # take: increment ba, account bits, update mnr
        tf = fidx[take]
        tch = pch[take]
        tsb = psb[take]
        ba[tf, tch, tsb] += 1
        bspl[take] += inc[take]
        bscf[take] += scale[take]
        bsel[take] += seli[take]
        used[tf, tch, tsb] = 1
        newba = ba[tf, tch, tsb]
        mnr[tf, tch, tsb] = (-smr[tf, tch, tsb]
                             + snr_after[tsb, newba])
        maxed = newba >= maxba[tsb]
        used[tf[maxed], tch[maxed], tsb[maxed]] = 2
        # freeze
        used[fidx[freeze], pch[freeze], psb[freeze]] = 2
        # joint copy
        if nch == 2:
            jmask = has & js[fidx, psb]
            jf = fidx[jmask]
            jch = 1 - pch[jmask]
            jsb_ = psb[jmask]
            ba[jf, jch, jsb_] = ba[jf, 1 - jch, jsb_]
            used[jf, jch, jsb_] = used[jf, 1 - jch, jsb_]
            mnr[jf, jch, jsb_] = (-smr[jf, jch, jsb_]
                                  + snr_after[jsb_, ba[jf, jch, jsb_]])

    ad = ad - bspl - bscf - bsel
    if layer == 2:
        ba[:, :, sblimit:] = 0
    return ba, ad.astype(np.int64)