"""Layer III rate/distortion loop in PyTorch (port of mp3tpu/ops/jaxloop.py).

Same batched, masked formulation as the JAX package: every function
works on a batch of granules (leading axis G), the stepsize search is a
fixed-depth bisection plus monotone walks, and the distortion loop runs
with per-lane convergence masks.  Counting differs in two places: each
bit evaluation of the searches (``_bits_at``) is one launch of the
``bits_at`` kernel on a CUDA tensor (``ops/bits_at.py``; its plain
version, this module's chain, on the CPU), and ``count_all``'s 256-class
pair histogram goes through K1 (``ops/hist_c1.py``); the TPU's one-hot
factorization is not ported.

Each ``lax.while_loop`` of the JAX package whose exit is
``jnp.any(...)`` becomes a Python loop whose condition is read on the
host -- one device sync per step on CUDA, counted in
``any_on_host.syncs``.  Loop bodies, caps and the fixed 3-step downward
walk keep the JAX semantics exactly.

Bit arithmetic stays in int32/int64 and float32 bit totals, as in the
JAX package; nothing here uses unsigned tensors.
"""
from functools import lru_cache

import numpy as np
import torch

from ..tables import mpeg
from ..runtime.profiling import span
from ..tables.huffman import ESC_TABLE_A, ESC_TABLE_B, FIRST_TABLE_FOR_MAX

from . import bits_at
from .hist_c1 import hist_c1

IXMAX = 8191 + 14  # table range limit (loop.c:588)
QMIN, QMAX = -210.0, 45.0  # global_gain in [0, 255]
# float -> int32 conversion saturates here, as XLA's does, instead of
# wrapping to INT_MIN (the largest float32 below 2**31)
_INT32_SAT = 2147483520.0

_PRETAB = mpeg.PRETAB.astype(np.float32)
_SQRT2 = float(np.sqrt(2.0))
_SQRT2_75 = float(np.sqrt(2.0) ** 0.75)
# the JAX package's own numpy expressions, so the gains are bit-equal
_PRE_GAIN = _SQRT2 ** _PRETAB
_PRE_GAIN75 = (_SQRT2 ** _PRETAB) ** 0.75
_PRE_XMIN = _SQRT2 ** (2 * _PRETAB)


@lru_cache(maxsize=None)
def static_tables(version, sampling_frequency):
    """Per-samplerate numpy tables; equal to ``jaxloop._static``."""
    sfb_l = mpeg.sfb_long(version, sampling_frequency)
    sfb_s = mpeg.sfb_short(version, sampling_frequency)
    oh_l = np.zeros((576, 21))
    for sfb in range(21):
        oh_l[sfb_l[sfb]:sfb_l[sfb + 1], sfb] = 1.0
    bw_l = (sfb_l[1:22] - sfb_l[:21]).astype(np.float64)
    oh_s = np.zeros((192, 12))
    for sfb in range(12):
        oh_s[sfb_s[sfb]:sfb_s[sfb + 1], sfb] = 1.0
    bw_s = (sfb_s[1:13] - sfb_s[:12]).astype(np.float64)
    # short-block pair permutation: traversal sfb -> window -> line
    perm = np.array([3 * line + w
                     for sfb in range(13) for w in range(3)
                     for line in range(int(sfb_s[sfb]), int(sfb_s[sfb + 1]))],
                    np.int32)
    # region-0 boundary in permuted pair space: sfbs with start < 12
    r0_pairs = sum(3 * (int(sfb_s[s + 1]) - int(sfb_s[s])) // 2
                   for s in range(13) if sfb_s[s] < 12)
    # short-band gain matrix in PERMUTED line order
    oh_sp = np.zeros((576, 36))
    for q in range(576):
        line, w = int(perm[q]) // 3, int(perm[q]) % 3
        for band in range(12):
            if sfb_s[band] <= line < sfb_s[band + 1]:
                oh_sp[q, band * 3 + w] = 1.0
    return dict(sfb_l=np.asarray(sfb_l), sfb_s=np.asarray(sfb_s),
                oh_l=oh_l, bw_l=bw_l, oh_s=oh_s, bw_s=bw_s,
                perm_short=perm, r0_pairs_short=r0_pairs,
                oh_s_perm=oh_sp, lsf=(version != mpeg.MPEG1))


_FLOAT_KEYS = ("oh_l", "bw_l", "oh_s", "bw_s", "oh_s_perm", "pre_gain",
               "pre_gain75", "pre_xmin")
_INT_KEYS = ("sfb_l", "perm_short", "subdv", "first", "esc_a", "esc_b",
             "slen1", "slen2", "lim1", "lim2", "lsf_slots", "lsf_maxsfac",
             "log2_tab")


def device_tables(st, device):
    """Tensors on `device` for a ``static_tables`` (or ``jaxloop._static``)
    dict, plus the sample-rate independent lookup tables; the Python
    values r0_pairs_short and lsf ride along."""
    arrays = dict(st)
    nr = mpeg.NR_OF_SFB_BLOCK
    arrays.update(subdv=mpeg.SUBDV_TABLE, first=FIRST_TABLE_FOR_MAX,
                  esc_a=ESC_TABLE_A, esc_b=ESC_TABLE_B,
                  slen1=mpeg.SLEN1_TAB, slen2=mpeg.SLEN2_TAB,
                  lim1=2 ** mpeg.SLEN1_TAB, lim2=2 ** mpeg.SLEN2_TAB,
                  pre_gain=_PRE_GAIN, pre_gain75=_PRE_GAIN75,
                  pre_xmin=_PRE_XMIN,
                  # LSF partitions, [preflag][short]: table_number 0, or 2
                  # with preflag (loop.c:871-993)
                  lsf_slots=np.stack([nr[0][:2], nr[2][:2]]),
                  lsf_maxsfac=np.stack([mpeg.MAX_SFAC_TAB[0],
                                        mpeg.MAX_SFAC_TAB[2]]),
                  log2_tab=mpeg.LOG2_TAB)
    out = {k: torch.as_tensor(np.asarray(arrays[k]), dtype=dt, device=device)
           for keys, dt in ((_FLOAT_KEYS, torch.float32),
                            (_INT_KEYS, torch.int64)) for k in keys}
    # the bits_at kernel's per-rate tables in one int32 pack
    out["bits_at_tab"] = torch.as_tensor(bits_at.rate_tables(st["sfb_l"]),
                                         device=device)
    out["r0_pairs_short"] = int(st["r0_pairs_short"])
    out["lsf"] = bool(st["lsf"])
    return out


def any_on_host(mask):
    """``bool(mask.any())`` -- the exit test of a data-dependent loop.
    On CUDA it waits for the device; each call counts one sync."""
    any_on_host.syncs += 1
    return bool(mask.any())


any_on_host.syncs = 0


# ---------------------------------------------------------------------------
# quantize + run length + bit count
# ---------------------------------------------------------------------------

def _to_ix(v):
    return torch.floor(v).clamp_(0.0, _INT32_SAT).to(torch.int32)


def quantize(xr_abs, qss):
    """ix = round((|xr| 2^{-s/4})^0.75 - 0.0946); xr_abs (G,576), qss (G,)."""
    istep = torch.exp2(-0.25 * qss)[:, None]
    return _to_ix(torch.pow(xr_abs * istep, 0.75) - 0.0946 + 0.5)


def quantize_pow75(xr75, qss):
    """quantize() with |xr|^0.75 precomputed: xr75 * 2^{-3s/16}."""
    istep75 = torch.exp2(-0.1875 * qss)[:, None]
    return _to_ix(xr75 * istep75 - 0.0946 + 0.5)


def calc_runlen(ix, is_short):
    """count1, big_values (loop.c:1488-1519) from the last nonzero pair
    and the last pair with a component > 1."""
    G = ix.shape[0]
    pairs = ix.reshape(G, 288, 2)
    idx = torch.arange(288, device=ix.device)[None, :]
    p_nz = torch.where((pairs != 0).any(dim=2), idx, -1).amax(dim=1)
    p_big = torch.where((pairs > 1).any(dim=2), idx, -1).amax(dim=1)
    count1 = (p_nz - p_big) // 2
    big_values = p_nz + 1 - 2 * count1
    count1 = torch.where(is_short, 0, count1)
    big_values = torch.where(is_short, 288, big_values)
    return count1.to(torch.int32), big_values.to(torch.int32)


def subdivide(big_values, is_short, is_short_block, ST):
    """Region counts and addresses (loop.c:1638-1703).  Returns r0, r1,
    a1, a2 (a3 == 2 * big_values); all zero where big_values == 0."""
    sfb_l = ST["sfb_l"]
    dev = sfb_l.device
    bvr = 2 * big_values.to(torch.int64)
    scfb_anz = (sfb_l[None, :] < bvr[:, None]).sum(dim=1).clamp(0, 22)
    r0_init = ST["subdv"][scfb_anz, 0]
    r1_init = ST["subdv"][scfb_anz, 1]
    r = torch.arange(22, device=dev)[None, :]
    # decrement r while sfb_l[r+1] > bvr (r down to 0)
    fits0 = sfb_l[None, 1:23] <= bvr[:, None]
    r0 = torch.where((r <= r0_init[:, None]) & fits0, r, 0).amax(dim=1)
    fits1 = sfb_l[(r0[:, None] + r + 2).clamp(0, 22)] <= bvr[:, None]
    r1 = torch.where((r <= r1_init[:, None]) & fits1, r, 0).amax(dim=1)
    a1 = torch.minimum(sfb_l[(r0 + 1).clamp(0, 22)], bvr)
    a2 = torch.minimum(torch.maximum(sfb_l[(r0 + r1 + 2).clamp(0, 22)], a1),
                       bvr)
    # window-switched non-short (start/stop) blocks (loop.c:1694-1701)
    ws = is_short_block & ~is_short
    r0 = torch.where(ws, 7, r0)
    r1 = torch.where(ws, 13, r1)
    a1 = torch.where(ws, torch.minimum(sfb_l[8], bvr), a1)
    a2 = torch.where(ws, bvr, a2)
    # short blocks: fixed region counts (loop.c:1686-1692)
    r0 = torch.where(is_short, 8, r0)
    r1 = torch.where(is_short, 36, r1)
    z = big_values == 0
    return tuple(torch.where(z, 0, v).to(torch.int32)
                 for v in (r0, r1, a1, a2))


def choose_tables(bits_tab, mx, ST):
    """new_choose_table candidate logic (loop.c:1793-1899), branchless.
    bits_tab (G,3,32) float32, mx (G,3) -> table (G,3) int32, bits (G,3)."""
    mx = mx.to(torch.int64)
    first = ST["first"][mx.clamp(0, 14)]
    esc_a = ST["esc_a"][(mx - 15).clamp(0, 8192)]
    esc_b = ST["esc_b"][(mx - 15).clamp(0, 8192)]

    def bt(t):
        return torch.gather(bits_tab, 2, t[..., None])[..., 0]

    # small-value path with the reference's pairwise candidate tries
    c = first
    s = bt(c)
    for base, cands in ((2, (3,)), (5, (6,)), (7, (8, 9)), (10, (11, 12)),
                        (13, (15,))):
        for alt in cands:
            altb = bits_tab[..., alt]
            better = (first == base) & (altb <= s)
            c = torch.where(better, alt, c)
            s = torch.where(better, altb, s)
    # ESC path
    sa = bt(esc_a)
    sb = bt(esc_b)
    c = torch.where(mx >= 15, torch.where(sb < sa, esc_b, esc_a), c)
    s = torch.where(mx >= 15, torch.minimum(sa, sb), s)
    c = torch.where(mx == 0, 0, c)
    s = torch.where(mx == 0, 0.0, s)
    return c.to(torch.int32), s


def count_all(ix, is_short, is_short_block, ST, pre_permuted=False,
              hist=None):
    """Full noiseless-coding analysis of a quantized batch ix (G,576)
    int32.  pre_permuted: ix already in traversal order.  hist: the
    histogram function (default ``hist_c1``: K1 on a CUDA tensor).

    Returns dict: bits (G,) float32, count1, big_values, r0, r1, a1, a2,
    table_select (G,3), count1table_select (G,), ix_max (G,)."""
    if pre_permuted:
        ixp = ix
    else:
        ixp = torch.where(is_short[:, None], ix[:, ST["perm_short"]], ix)
    ixp = ixp.contiguous()
    count1, big_values = calc_runlen(ixp, is_short)
    r0, r1, a1, a2 = subdivide(big_values, is_short, is_short_block, ST)
    bits_tab, mx, b0raw, signs = (hist or hist_c1)(
        ixp, a1, a2, big_values, count1, is_short.contiguous(),
        ST["r0_pairs_short"])
    b0 = (b0raw + signs).to(torch.float32)
    b1 = (4 * count1 + signs).to(torch.float32)
    c1_sel = torch.where(b0 < b1, 0, 1).to(torch.int32)
    c1_bits = torch.where(c1_sel == 0, b0, b1)
    tables, region_bits = choose_tables(bits_tab, mx, ST)
    # short blocks only use regions 0/1
    region_ok = (torch.arange(3, device=ix.device)[None, :] < 2) \
        | ~is_short[:, None]
    bigv_bits = (region_bits * region_ok).sum(dim=1)
    tables = (tables * region_ok).to(torch.int32)
    return dict(bits=bigv_bits + c1_bits, count1=count1,
                big_values=big_values, r0=r0, r1=r1, a1=a1, a2=a2,
                table_select=tables, count1table_select=c1_sel,
                ix_max=ixp.amax(dim=1))


# ---------------------------------------------------------------------------
# distortion + allowed distortion
# ---------------------------------------------------------------------------

def _per_sfb(v, ST):
    """Band means of a (G, 576) energy: long (G, 21), short (G, 12, 3)."""
    G = v.shape[0]
    long_ = (v @ ST["oh_l"]) / ST["bw_l"]
    short = torch.einsum("gls,lb->gbs", v.reshape(G, 192, 3), ST["oh_s"]) \
        / ST["bw_s"][None, :, None]
    return long_, short


def calc_noise(xr_abs, ix, qss, ST):
    """Per-sfb quantization noise (loop.c:1007-1070).
    Returns xfsf_l (G,21), xfsf_s (G,12,3)."""
    step = torch.exp2(0.25 * qss)[:, None]
    dq = torch.pow(ix.to(torch.float32), 4.0 / 3.0) * step
    return _per_sfb((xr_abs - dq) ** 2, ST)


def calc_xmin(xr_abs, ratio_l, ratio_s, ST):
    """Allowed distortion (loop.c:1085-1119)."""
    en_l, en_s = _per_sfb(xr_abs * xr_abs, ST)
    return ratio_l * en_l, ratio_s * en_s


def quantanf_init(xr_abs):
    """SFM-based initial stepsize (loop.c:369-402)."""
    nz = xr_abs != 0.0
    tpd = torch.where(nz, xr_abs * xr_abs, 1.0)
    sum1 = torch.where(nz, torch.log(tpd), 0.0).sum(dim=1)
    sum2 = torch.where(nz, tpd, 0.0).sum(dim=1)
    sfm = torch.exp(sum1 / 576.0) / torch.clamp(sum2 / 576.0, min=1e-30)
    tp = torch.clamp(torch.round(8.0 * torch.log(sfm)), min=-100.0)
    return torch.where(sum2 > 0, tp - 70.0, -70.0)


# ---------------------------------------------------------------------------
# scalefactor bit accounting
# ---------------------------------------------------------------------------

def scale_bitcount(sf_l, sf_s, is_short, ST, skip_mask=None):
    """MPEG-1 scalefac_compress selection (loop.c:792-856).
    skip_mask (G, 21): long sfbs whose scalefactors are NOT transmitted.
    Returns compress (G,), part2 (G,), overflow (G,)."""
    max1 = torch.where(is_short, sf_s[:, :6, :].amax(dim=(1, 2)),
                       sf_l[:, :11].amax(dim=1))
    max2 = torch.where(is_short, sf_s[:, 6:12, :].amax(dim=(1, 2)),
                       sf_l[:, 11:21].amax(dim=1))
    fits = ((max1[:, None] < ST["lim1"][None, :])
            & (max2[:, None] < ST["lim2"][None, :]))
    # first fitting entry (argmax of a bool is refused; argmax returns
    # the first maximum)
    k = fits.to(torch.int32).argmax(dim=1)
    overflow = ~fits.any(dim=1)
    slen1 = ST["slen1"][k]
    slen2 = ST["slen2"][k]
    n1 = torch.full_like(slen1, 11)
    n2 = torch.full_like(slen2, 10)
    if skip_mask is not None:
        n1 = n1 - skip_mask[:, :11].sum(dim=1)
        n2 = n2 - skip_mask[:, 11:21].sum(dim=1)
    part2 = torch.where(is_short, 18 * slen1 + 18 * slen2,
                        n1 * slen1 + n2 * slen2)
    return k.to(torch.int32), part2.to(torch.int32), overflow


def _partition_max(sf, parts, per):
    """(G, 4) maxima of sf over consecutive partitions of parts[p] // per
    bands each; an empty partition gives 0 (scalefactors are >= 0)."""
    G = sf.shape[0]
    outs, s = [], 0
    for n in parts:
        e = s + int(n) // per
        outs.append(sf[:, s:e].reshape(G, -1).amax(dim=1) if e > s
                    else torch.zeros(G, dtype=sf.dtype, device=sf.device))
        s = e
    return torch.stack(outs, dim=1)


def scale_bitcount_lsf(sf_l, sf_s, is_short, preflag, ST):
    """MPEG-2 LSF slen/scalefac_compress selection (loop.c:871-993).
    Non-intensity channels use table_number 0 (2 with preflag); rows 0
    (long) / 1 (short, counted in thirds); no mixed blocks.
    Returns compress (G,), part2 (G,), overflow (G,)."""
    nr = mpeg.NR_OF_SFB_BLOCK

    def maxima(t):
        return torch.where(is_short[:, None],
                           _partition_max(sf_s, nr[t][1], 3),
                           _partition_max(sf_l, nr[t][0], 1))

    pre = preflag == 1
    max_sfac = torch.where(pre[:, None], maxima(2), maxima(0))    # (G, 4)
    p = pre.to(torch.int64)
    overflow = (max_sfac > ST["lsf_maxsfac"][p]).any(dim=1)
    slen = ST["log2_tab"][max_sfac.clamp(0, 15).to(torch.int64)]
    compress0 = (((slen[:, 0] * 5 + slen[:, 1]) << 4) + (slen[:, 2] << 2)
                 + slen[:, 3])
    compress2 = 500 + slen[:, 0] * 3 + slen[:, 1]
    compress = torch.where(pre, compress2, compress0)
    slots = ST["lsf_slots"][p, is_short.to(torch.int64)]          # (G, 4)
    part2 = (slen * slots).sum(dim=1)
    return compress.to(torch.int32), part2.to(torch.int32), overflow


# ---------------------------------------------------------------------------
# stepsize search + outer loop
# ---------------------------------------------------------------------------

def _bits_at(xr75p, qss, is_short, is_short_block, ST):
    """Bits + full counts at a stepsize; xr75p is the PERMUTED |xr|^0.75.
    One ``bits_at`` launch on a CUDA tensor, its plain chain on the CPU."""
    c = bits_at.bits_at(xr75p, qss, is_short, is_short_block, ST)
    return c["bits"], c


def _bits_only(xr75p, qss, is_short, is_short_block, ST):
    """Bit count at a candidate stepsize, nothing else."""
    return _bits_at(xr75p, qss, is_short, is_short_block, ST)[0]


def _walk_up(xr75p, budget, qss, bits, is_short, is_short_block, ST,
             max_steps):
    """Step every over-budget lane up by one until all fit (or the cap)."""
    it = 0
    while it < max_steps and any_on_host(bits > budget):
        bad = bits > budget
        qss = torch.where(bad, qss + 1.0, qss)
        b2 = _bits_only(xr75p, qss, is_short, is_short_block, ST)
        bits = torch.where(bad, b2, bits)
        it += 1
    return qss, bits


def search_walk(xr75p, budget, start_qss, is_short, is_short_block, ST,
                max_steps=40):
    """Walk up from a warm start while over budget; returns (qss, bits,
    counts at qss)."""
    bits = _bits_only(xr75p, start_qss, is_short, is_short_block, ST)
    qss, bits = _walk_up(xr75p, budget, start_qss, bits, is_short,
                         is_short_block, ST, max_steps)
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


def search_stepsize(xr75p, budget, qanf, is_short, is_short_block, ST,
                    n_bisect=8, qss_lo=None):
    """Bisection on [lo, QMAX], an upward fix-up walk, then a fixed
    3-step downward refinement; returns (qss, bits, counts).

    qss_lo: optional warm lower bound for the bisection."""
    floor_q = torch.clamp(qanf, min=QMIN)
    lo = floor_q if qss_lo is None else torch.maximum(floor_q, qss_lo)
    hi = torch.full_like(lo, QMAX)          # always fits (all-zero ix)
    for _ in range(n_bisect):
        mid = torch.floor((lo + hi) * 0.5)
        ok = _bits_only(xr75p, mid, is_short, is_short_block, ST) <= budget
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    qss = hi
    bits = _bits_only(xr75p, qss, is_short, is_short_block, ST)
    qss, bits = _walk_up(xr75p, budget, qss, bits, is_short,
                         is_short_block, ST, 40)
    for _ in range(3):
        qss2 = qss - 1.0
        b2 = _bits_only(xr75p, qss2, is_short, is_short_block, ST)
        good = (b2 <= budget) & (qss2 >= floor_q)
        qss = torch.where(good, qss2, qss)
        bits = torch.where(good, b2, bits)
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


def _lanes(mask, v):
    return mask.reshape(mask.shape + (1,) * (v.dim() - 1))


def _sfb_gain(amp, oh):
    """1 + per-line gain from per-band amplification (G, B) -> (G, L).
    Lines outside every band keep gain 1."""
    return 1.0 + amp @ oh.T


@span("outer_loop")
def outer_loop(xr, budget, ratio_l, ratio_s, is_short_block, block_type,
               ST, max_iter=6, sf_fix_mask=None, sf_fix_val=None,
               sf_skip_mask=None, qss_lo=None):
    """Distortion-control loop (loop.c:415-558), batched & masked.

    xr (G, 576) float32 signed spectrum; budget (G,) float32 max bits.
    sf_fix_mask/sf_fix_val (G, 21): long sfbs whose scalefactors are
    FIXED (scfsi); sf_skip_mask (G, 21): fixed bands not transmitted.
    qss_lo: warm lower bound for the initial bisection.
    Returns dict of per-granule coding decisions (see jaxloop.outer_loop).
    """
    G = xr.shape[0]
    dev = xr.device
    is_short = is_short_block & (block_type == 2)
    long_ = ~is_short
    xr_abs = xr.abs()
    nonsilent = xr_abs.amax(dim=1) > 0.0
    xmin_l, xmin_s = calc_xmin(xr_abs, ratio_l, ratio_s, ST)
    qanf = quantanf_init(xr_abs)
    oh_l, oh_s, oh_sp = ST["oh_l"], ST["oh_s"], ST["oh_s_perm"]

    zi = torch.zeros(G, dtype=torch.int32, device=dev)
    sf_l = torch.zeros((G, 21), dtype=torch.int32, device=dev)
    sf_s = torch.zeros((G, 12, 3), dtype=torch.int32, device=dev)

    fixed = None
    if sf_fix_mask is not None:
        fixed = sf_fix_mask & long_[:, None]
        fv = torch.where(fixed, sf_fix_val.to(torch.int32), 0) \
            .to(torch.int32)
        sf_l = sf_l + fv
        # pre-amplify by the fixed scalefactors (ifqstep sqrt(2))
        gain = _sfb_gain(torch.pow(_SQRT2, fv.to(xr.dtype)) - 1.0, oh_l)
        xr_abs = torch.where(long_[:, None], xr_abs * gain, xr_abs)
        xmin_l = xmin_l * torch.pow(2.0, fv.to(xr.dtype))
    skip = None
    if sf_skip_mask is not None:
        skip = sf_skip_mask & long_[:, None]

    def sbc(sf_l, sf_s, preflag):
        if ST["lsf"]:
            return scale_bitcount_lsf(sf_l, sf_s, is_short, preflag, ST)
        return scale_bitcount(sf_l, sf_s, is_short, ST, skip_mask=skip)

    perm = ST["perm_short"]
    # initial full bisection once; iterations warm-walk from its result
    xr75 = torch.pow(xr_abs, 0.75)
    xr75p = torch.where(is_short[:, None], xr75[:, perm], xr75)
    qss_init, _, _ = search_stepsize(xr75p, budget, qanf, is_short,
                                     is_short_block, ST, qss_lo=qss_lo)

    xr_a = xr_abs
    preflag = zi.clone()
    qss_prev = qss_init
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    filling = done.clone()
    fill_rounds = zi.clone()
    best = dict(ix=torch.zeros((G, 576), dtype=torch.int32, device=dev),
                qss=qanf, bits=budget * 0, part2=zi, compress=zi,
                sf_l=sf_l, sf_s=sf_s, preflag=zi, used=zi, count1=zi,
                big_values=zi, r0=zi, r1=zi, a1=zi, a2=zi,
                table_select=torch.zeros((G, 3), dtype=torch.int32,
                                         device=dev),
                count1table_select=zi)

    it = 0
    while it < max_iter and any_on_host(~done):
        compress, part2, overflow = sbc(sf_l, sf_s, preflag)
        huff = torch.clamp(budget - part2, min=0.0)
        qss, bits, c = search_walk(xr75p, huff, qss_prev, is_short,
                                   is_short_block, ST)
        ix = quantize_pow75(xr75, qss)
        xfsf_l, xfsf_s = calc_noise(xr_a, ix, qss, ST)

        # keep the latest encoding as best; in the FILL phase accept
        # only results that spend strictly more of the granted bits
        used_new = (part2 + bits).to(torch.int32)
        new_best = dict(ix=ix, qss=qss, bits=bits, part2=part2,
                        compress=compress, sf_l=sf_l, sf_s=sf_s,
                        preflag=preflag, used=used_new,
                        count1=c["count1"], big_values=c["big_values"],
                        r0=c["r0"], r1=c["r1"], a1=c["a1"], a2=c["a2"],
                        table_select=c["table_select"],
                        count1table_select=c["count1table_select"])
        upd = (~done) & ((~filling) | (used_new > best["used"]))
        best = {k: torch.where(_lanes(upd, best[k]), new_best[k], best[k])
                for k in best}
        upd = ~done

        # preemphasis (long only, once); the reference amplifies with
        # the pre-preemphasis noise, and so does this loop
        over_hi = (xfsf_l[:, 17:21] > xmin_l[:, 17:21]).sum(dim=1)
        trigger_pre = long_ & (preflag == 0) & (over_hi == 4) & upd
        tp = trigger_pre[:, None]
        pre75 = 1.0 + oh_l @ (ST["pre_gain75"] - 1.0)
        xr_a = torch.where(tp, xr_a * (1.0 + oh_l @ (ST["pre_gain"] - 1.0)),
                           xr_a)
        xr75 = torch.where(tp, xr75 * pre75, xr75)
        # preemphasis is long-only, where xr75p == xr75 line for line
        xr75p = torch.where(tp, xr75p * pre75, xr75p)
        xmin_l = torch.where(tp, xmin_l * ST["pre_xmin"], xmin_l)
        preflag = torch.where(trigger_pre, 1, preflag).to(torch.int32)

        # amplify distorted bands by sqrt(2); xmin doubles accordingly
        over_l = (xfsf_l > xmin_l) & long_[:, None] & upd[:, None]
        if fixed is not None:
            over_l = over_l & ~fixed
        over_s = (xfsf_s > xmin_s) & is_short[:, None, None] \
            & upd[:, None, None]

        # budget FILL: a budget-limited granule about to stop with a
        # large unspent gap amplifies only its k most distorted bands
        over_any_real = over_l.any(dim=1) | over_s.any(dim=2).any(dim=1)
        amped_or_over_l = (sf_l > 0) | over_l
        if fixed is not None:
            amped_or_over_l = amped_or_over_l | fixed
        prosp_stop = torch.where(
            is_short, ((sf_s > 0) | over_s).reshape(G, 36).all(dim=1),
            amped_or_over_l.all(dim=1)) | ~over_any_real
        slack = budget - used_new.to(budget.dtype)
        fillable = (budget < 4000.0) & (slack > 32.0) & (fill_rounds < 2) \
            & nonsilent
        filling = filling | (upd & prosp_stop & fillable & ~overflow)
        use_subset = filling & upd & fillable
        fill_rounds_next = fill_rounds + use_subset.to(torch.int32)
        k = torch.clamp((slack / 40.0).to(torch.int32), 1, 20) \
            .to(torch.int64)
        ratio_fill_l = xfsf_l / torch.clamp(xmin_l, min=1e-30)
        thresh_l = torch.sort(ratio_fill_l, dim=1, descending=True).values \
            .gather(1, (k - 1)[:, None])
        topk_l = ratio_fill_l >= thresh_l
        if fixed is not None:
            topk_l = topk_l & ~fixed
        over_l = torch.where((use_subset & long_)[:, None], topk_l, over_l)
        ratio_fill_s = (xfsf_s / torch.clamp(xmin_s, min=1e-30)) \
            .reshape(G, 36)
        # the short path indexes with clip(k, 1, 35) where the long path
        # uses k - 1: kept as the JAX package has it
        thresh_s = torch.sort(ratio_fill_s, dim=1, descending=True).values \
            .gather(1, torch.clamp(k, 1, 35)[:, None])
        topk_s = (ratio_fill_s >= thresh_s).reshape(G, 12, 3)
        over_s = torch.where((use_subset & is_short)[:, None, None], topk_s,
                             over_s)
        sf_l = sf_l + over_l.to(torch.int32)
        sf_s = sf_s + over_s.to(torch.int32)
        xmin_l = torch.where(over_l, xmin_l * 2.0, xmin_l)
        xmin_s = torch.where(over_s, xmin_s * 2.0, xmin_s)
        over_lf = over_l.to(xr.dtype)
        gain_long = _sfb_gain(over_lf * (_SQRT2 - 1.0), oh_l)
        gain_long75 = _sfb_gain(over_lf * (_SQRT2_75 - 1.0), oh_l)
        lm = long_[:, None]
        xr_a = torch.where(lm, xr_a * gain_long, xr_a)
        xr75 = torch.where(lm, xr75 * gain_long75, xr75)
        xr75p = torch.where(lm, xr75p * gain_long75, xr75p)
        over_sf = over_s.to(xr.dtype)
        amp_s = over_sf * (_SQRT2 - 1.0)                 # (G, 12, 3)
        amp_s75 = over_sf * (_SQRT2_75 - 1.0)
        gain_s = 1.0 + torch.einsum("lb,gbs->gls", oh_s, amp_s) \
            .reshape(G, 576)
        gain_s75 = 1.0 + torch.einsum("lb,gbs->gls", oh_s, amp_s75) \
            .reshape(G, 576)
        sm = is_short[:, None]
        xr_a = torch.where(sm, xr_a * gain_s, xr_a)
        xr75 = torch.where(sm, xr75 * gain_s75, xr75)
        # permuted-order short gain via the precomputed line map
        xr75p = torch.where(sm, xr75p * _sfb_gain(amp_s75.reshape(G, 36),
                                                  oh_sp), xr75p)

        over_any = over_l.any(dim=1) | over_s.any(dim=2).any(dim=1)
        qss_prev = qss
        amped_l = (sf_l > 0) if fixed is None else ((sf_l > 0) | fixed)
        all_amped = torch.where(is_short,
                                (sf_s > 0).reshape(G, 36).all(dim=1),
                                amped_l.all(dim=1))
        overflow2 = sbc(sf_l, sf_s, preflag)[2]
        done = done | overflow2 | torch.where(
            filling, (slack <= 32.0) | (fill_rounds_next >= 2),
            ~over_any | all_amped)
        fill_rounds = fill_rounds_next
        it += 1

    silent = xr.abs().amax(dim=1) == 0.0
    out = dict(best)
    out.pop("used")
    p23 = (best["part2"] + best["bits"]).to(torch.int32)
    # iteration-0 stepsize: the sound warm lower bound for a later
    # encode of the same spectrum at an equal-or-smaller budget
    out["qss0"] = qss_init
    out["part2_3_length"] = torch.where(silent, 0, p23).to(torch.int32)
    out["global_gain"] = torch.where(
        silent, 210, torch.round(best["qss"] + 210.0).to(torch.int32)) \
        .to(torch.int32)
    out["block_type"] = block_type
    out["window_switching_flag"] = is_short_block.to(torch.int32)
    return out
