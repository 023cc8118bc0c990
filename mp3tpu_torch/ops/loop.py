"""Layer III rate/distortion loop in PyTorch (port of mp3tpu/ops/jaxloop.py).

Same batched, masked formulation as the JAX package: every function
works on a batch of granules (leading axis G), the stepsize search is a
fixed-depth bisection plus monotone walks, and the distortion loop runs
with per-lane convergence masks.

The stepsize searches, device loops in the JAX package, are one launch
each of K3 on a CUDA tensor (``ops/search.py``, ``csrc/bits_at.cu``):
every granule runs its own search to its own exit on the card, with no
host round trip.  On a CPU tensor they run ``search_stepsize_plain`` and
``search_walk_plain``, the lockstep loops with the JAX semantics (caps,
fixed 3-step downward walk), each bit evaluation one ``_bits_at``
(``ops/bits_at.py``: its plain chain on the CPU, the ``bits_at`` kernel
if the plain searches are given a CUDA tensor).  ``count_all``'s
256-class pair histogram goes through K1 (``ops/hist_c1.py``); the TPU's
one-hot factorization is not ported.

Each ``lax.while_loop`` of the JAX package whose exit is
``jnp.any(...)`` and that is not inside a K3 launch or a graph (the
plain searches' walks, and ``outer_loop``'s own when it runs op by op)
is a Python loop whose condition is read on the host -- one device sync
per step on CUDA, counted in ``any_on_host.syncs``.

``outer_loop`` is three functions over one state: ``_prologue`` (up to
and with the initial stepsize search), ``_iteration`` (one step of the
while loop, updating the state in place) and ``_epilogue``.  On a CUDA
tensor the prologue and ``max_iter`` iterations unrolled
(``_iterations``) are each captured once per key as a CUDA graph and
replayed, one replay each a call with no exit read on the host (the
port's counterpart of the JAX package's compiled ``while_loop``;
``GRAPHS``, counted in ``graph_counts``), and so is a continuation
(``Then``: the final encode's emission and packing) that reads the
loop's static tensors after the last iteration: three programs of one
entry, captured and replayed by ``graphs.run`` and ``graphs.run_next``
(``_run_loop``); ``outer_loop_eager`` dispatches the same functions op
by op with the host exit, and is what the CPU runs.
Inside the segment program's one graph the rate loop is ``unrolled``:
the same three parts in one function of tensors.

Unrolling is exact: an iteration writes ``best`` only where ``upd =
~done`` holds, and ``done`` only grows, so once every lane is done an
iteration leaves ``best`` and ``qss0`` -- all that the epilogue and the
emission read -- as they were.  The state it still writes (``qss_prev``
unmasked, the start of the next walk; the rest under ``upd`` or only
growing) reaches ``best`` only through ``upd``, so it too changes no
output.  ``iterations_on(device)`` sums, on the device, the iterations
in which some lane was live (``state["iters"]``): the count of
``jaxloop``'s ``iter_cond``, read after the encode's fetch.

Bit arithmetic stays in int32/int64 and float32 bit totals, as in the
JAX package; nothing here uses unsigned tensors.
"""
from functools import lru_cache
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..tables import mpeg
from ..runtime.profiling import span
from ..tables.huffman import ESC_TABLE_A, ESC_TABLE_B, FIRST_TABLE_FOR_MAX

from . import bits_at, graphs, search
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
    values r0_pairs_short and lsf ride along.

    Equal tables on one device give the same tensors
    (``graphs.shared_tensors``): the captured rate loops are keyed by the
    tables' identity, so that every encoder of a sample rate finds the
    graphs of the first."""
    return _with_values(graphs.shared_tensors(_numpy_tables(st), device),
                        st)


def _device_tables(st, device):
    """``device_tables`` made anew: tensors of their own."""
    return _with_values({k: torch.as_tensor(v, device=device)
                         for k, v in _numpy_tables(st).items()}, st)


def _with_values(tables, st):
    tables.update(r0_pairs_short=int(st["r0_pairs_short"]),
                  lsf=bool(st["lsf"]))
    return tables


def _numpy_tables(st):
    """``device_tables``' arrays, each of its tensor's dtype."""
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
    out = {k: np.asarray(arrays[k], dt)
           for keys, dt in ((_FLOAT_KEYS, np.float32),
                            (_INT_KEYS, np.int64)) for k in keys}
    # the bits_at kernel's per-rate tables in one int32 pack
    out["bits_at_tab"] = np.asarray(bits_at.rate_tables(st["sfb_l"]))
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


def _walk_up_plain(xr75p, budget, qss, bits, is_short, is_short_block, ST,
                   max_steps):
    """Step every over-budget lane up by one until all fit (or the cap).
    Returns (qss, bits, steps): steps (G,) int32, each lane's own."""
    steps = torch.zeros(qss.shape, dtype=torch.int32, device=qss.device)
    it = 0
    while it < max_steps and any_on_host(bits > budget):
        bad = bits > budget
        qss = torch.where(bad, qss + 1.0, qss)
        b2 = _bits_only(xr75p, qss, is_short, is_short_block, ST)
        bits = torch.where(bad, b2, bits)
        steps += bad
        it += 1
    return qss, bits, steps


def search_walk_plain(xr75p, budget, start_qss, is_short, is_short_block,
                      ST, max_steps=40):
    """Walk up from a warm start while over budget, the batch in lockstep;
    returns (qss, bits, counts at qss).  The counts hold ``evals``, each
    lane's own bit evaluations (its steps and the two at either end)."""
    bits = _bits_only(xr75p, start_qss, is_short, is_short_block, ST)
    qss, bits, steps = _walk_up_plain(xr75p, budget, start_qss, bits,
                                      is_short, is_short_block, ST, max_steps)
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    c["evals"] = steps + 2
    return qss, bits, c


def search_stepsize_plain(xr75p, budget, qanf, is_short, is_short_block, ST,
                          n_bisect=8, qss_lo=None):
    """Bisection on [lo, QMAX], an upward fix-up walk, then a fixed
    3-step downward refinement, the batch in lockstep; returns (qss, bits,
    counts), the counts with ``evals`` as in ``search_walk_plain``.

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
    qss, bits, steps = _walk_up_plain(xr75p, budget, qss, bits, is_short,
                                      is_short_block, ST, 40)
    for _ in range(3):
        qss2 = qss - 1.0
        b2 = _bits_only(xr75p, qss2, is_short, is_short_block, ST)
        good = (b2 <= budget) & (qss2 >= floor_q)
        qss = torch.where(good, qss2, qss)
        bits = torch.where(good, b2, bits)
    bits, c = _bits_at(xr75p, qss, is_short, is_short_block, ST)
    c["evals"] = steps + (n_bisect + 5)
    return qss, bits, c


def search_walk(xr75p, budget, start_qss, is_short, is_short_block, ST,
                max_steps=40):
    """Walk up from a warm start while over budget; returns (qss, bits,
    counts at qss): K3 (``ops/search.py``) on a CUDA tensor,
    ``search_walk_plain`` on a CPU tensor."""
    return search.search_walk(xr75p, budget, start_qss, is_short,
                              is_short_block, ST, max_steps=max_steps)


def search_stepsize(xr75p, budget, qanf, is_short, is_short_block, ST,
                    n_bisect=8, qss_lo=None):
    """Bisection on [lo, QMAX], an upward fix-up walk, then a fixed
    3-step downward refinement; returns (qss, bits, counts): K3
    (``ops/search.py``) on a CUDA tensor, ``search_stepsize_plain`` on a
    CPU tensor.

    qss_lo: optional warm lower bound for the bisection."""
    return search.search_stepsize(xr75p, budget, qanf, is_short,
                                  is_short_block, ST, n_bisect=n_bisect,
                                  qss_lo=qss_lo)


def _lanes(mask, v):
    return mask.reshape(mask.shape + (1,) * (v.dim() - 1))


def _sfb_gain(amp, oh):
    """1 + per-line gain from per-band amplification (G, B) -> (G, L).
    Lines outside every band keep gain 1."""
    return 1.0 + amp @ oh.T


# ---------------------------------------------------------------------------
# outer loop: a prologue, an iteration body and an epilogue over one state
# ---------------------------------------------------------------------------

#: the state entries that ``_iteration`` updates in place (besides best)
LOOP_STATE = ("xr_a", "xr75", "xr75p", "xmin_l", "xmin_s", "sf_l", "sf_s",
              "preflag", "qss_prev", "done", "filling", "fill_rounds",
              "iters")


def _sbc(state, sf_l, sf_s, preflag, ST):
    """Scalefactor bits of the batch: (compress, part2, overflow)."""
    if ST["lsf"]:
        return scale_bitcount_lsf(sf_l, sf_s, state["is_short"], preflag, ST)
    return scale_bitcount(sf_l, sf_s, state["is_short"], ST,
                          skip_mask=state["skip"])


def _prologue(xr, budget, ratio_l, ratio_s, is_short_block, block_type, ST,
              sf_fix_mask=None, sf_fix_val=None, sf_skip_mask=None,
              qss_lo=None):
    """``outer_loop`` up to and with its initial stepsize search.

    Returns (state, best).  state holds what the iterations read (the
    inputs budget and is_short_block, is_short, long_, nonsilent, the
    masks fixed and skip or None, the initial stepsize qss0) and the
    LOOP_STATE entries they update; best the coding decisions kept so
    far.  Every tensor that an iteration writes is its own."""
    G = xr.shape[0]
    dev = xr.device
    is_short = is_short_block & (block_type == 2)
    long_ = ~is_short
    xr_abs = xr.abs()
    nonsilent = xr_abs.amax(dim=1) > 0.0
    xmin_l, xmin_s = calc_xmin(xr_abs, ratio_l, ratio_s, ST)
    qanf = quantanf_init(xr_abs)

    def zeros(*shape):
        return torch.zeros((G,) + shape, dtype=torch.int32, device=dev)

    sf_l = zeros(21)
    fixed = skip = None
    if sf_fix_mask is not None:
        fixed = sf_fix_mask & long_[:, None]
        fv = torch.where(fixed, sf_fix_val.to(torch.int32), 0) \
            .to(torch.int32)
        sf_l = sf_l + fv
        # pre-amplify by the fixed scalefactors (ifqstep sqrt(2))
        gain = _sfb_gain(torch.pow(_SQRT2, fv.to(xr.dtype)) - 1.0,
                         ST["oh_l"])
        xr_abs = torch.where(long_[:, None], xr_abs * gain, xr_abs)
        xmin_l = xmin_l * torch.pow(2.0, fv.to(xr.dtype))
    if sf_skip_mask is not None:
        skip = sf_skip_mask & long_[:, None]

    # initial full bisection once; iterations warm-walk from its result
    xr75 = torch.pow(xr_abs, 0.75)
    xr75p = torch.where(is_short[:, None], xr75[:, ST["perm_short"]], xr75)
    qss_init, _, _ = search_stepsize(xr75p, budget, qanf, is_short,
                                     is_short_block, ST, qss_lo=qss_lo)

    done = torch.zeros(G, dtype=torch.bool, device=dev)
    state = dict(budget=budget, is_short_block=is_short_block,
                 is_short=is_short, long_=long_, nonsilent=nonsilent,
                 fixed=fixed, skip=skip, qss0=qss_init,
                 xr_a=xr_abs, xr75=xr75, xr75p=xr75p, xmin_l=xmin_l,
                 xmin_s=xmin_s, sf_l=sf_l, sf_s=zeros(12, 3),
                 preflag=zeros(), qss_prev=qss_init.clone(), done=done,
                 filling=done.clone(), fill_rounds=zeros(),
                 iters=torch.zeros((), dtype=torch.int32, device=dev))
    best = dict(ix=zeros(576), qss=qanf, bits=budget * 0, part2=zeros(),
                compress=zeros(), sf_l=sf_l.clone(), sf_s=zeros(12, 3),
                preflag=zeros(), used=zeros(), count1=zeros(),
                big_values=zeros(), r0=zeros(), r1=zeros(), a1=zeros(),
                a2=zeros(), table_select=zeros(3),
                count1table_select=zeros())
    return state, best


def _iteration(state, best, ST):
    """One iteration of ``outer_loop``'s while loop, in place: it reads
    state and best and copies each new value into its tensor (state's
    LOOP_STATE entries and every entry of best) at the end.  It makes
    only temporaries, reads no device value on the host and builds no
    tensor from host data, so that a CUDA graph can capture it."""
    budget, is_short, long_ = state["budget"], state["is_short"], \
        state["long_"]
    is_short_block, fixed = state["is_short_block"], state["fixed"]
    xr_a, xr75, xr75p = state["xr_a"], state["xr75"], state["xr75p"]
    xmin_l, xmin_s = state["xmin_l"], state["xmin_s"]
    sf_l, sf_s, preflag = state["sf_l"], state["sf_s"], state["preflag"]
    done, filling = state["done"], state["filling"]
    fill_rounds = state["fill_rounds"]
    oh_l, oh_s, oh_sp = ST["oh_l"], ST["oh_s"], ST["oh_s_perm"]
    G = budget.shape[0]
    # the iterations jaxloop's iter_cond lets run: some lane is live
    iters = state["iters"] + (~done).any().to(torch.int32)

    compress, part2, overflow = _sbc(state, sf_l, sf_s, preflag, ST)
    huff = torch.clamp(budget - part2, min=0.0)
    qss, bits, c = search_walk(xr75p, huff, state["qss_prev"], is_short,
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
    new_best = {k: torch.where(_lanes(upd, best[k]), new_best[k], best[k])
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
        & state["nonsilent"]
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
    over_lf = over_l.to(xr_a.dtype)
    gain_long = _sfb_gain(over_lf * (_SQRT2 - 1.0), oh_l)
    gain_long75 = _sfb_gain(over_lf * (_SQRT2_75 - 1.0), oh_l)
    lm = long_[:, None]
    xr_a = torch.where(lm, xr_a * gain_long, xr_a)
    xr75 = torch.where(lm, xr75 * gain_long75, xr75)
    xr75p = torch.where(lm, xr75p * gain_long75, xr75p)
    over_sf = over_s.to(xr_a.dtype)
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
    amped_l = (sf_l > 0) if fixed is None else ((sf_l > 0) | fixed)
    all_amped = torch.where(is_short,
                            (sf_s > 0).reshape(G, 36).all(dim=1),
                            amped_l.all(dim=1))
    overflow2 = _sbc(state, sf_l, sf_s, preflag, ST)[2]
    done = done | overflow2 | torch.where(
        filling, (slack <= 32.0) | (fill_rounds_next >= 2),
        ~over_any | all_amped)

    new = dict(xr_a=xr_a, xr75=xr75, xr75p=xr75p, xmin_l=xmin_l,
               xmin_s=xmin_s, sf_l=sf_l, sf_s=sf_s, preflag=preflag,
               qss_prev=qss, done=done, filling=filling,
               fill_rounds=fill_rounds_next, iters=iters)
    for k in LOOP_STATE:
        state[k].copy_(new[k])
    for k, v in new_best.items():
        best[k].copy_(v)


def _iterations(state, best, ST, max_iter):
    """``max_iter`` iterations with no exit: the loop as its graph runs
    it.  Past the iteration that leaves every lane done they change
    nothing that the epilogue reads (see the module's note)."""
    for _ in range(max_iter):
        _iteration(state, best, ST)


def _epilogue(xr, best, qss0, block_type, is_short_block):
    """``outer_loop``'s outputs from the kept decisions (best is taken
    over, less ``used``)."""
    silent = xr.abs().amax(dim=1) == 0.0
    out = dict(best)
    out.pop("used")
    p23 = (best["part2"] + best["bits"]).to(torch.int32)
    # iteration-0 stepsize: the sound warm lower bound for a later
    # encode of the same spectrum at an equal-or-smaller budget
    out["qss0"] = qss0
    out["part2_3_length"] = torch.where(silent, 0, p23).to(torch.int32)
    out["global_gain"] = torch.where(
        silent, 210, torch.round(best["qss"] + 210.0).to(torch.int32)) \
        .to(torch.int32)
    out["block_type"] = block_type
    out["window_switching_flag"] = is_short_block.to(torch.int32)
    return out


def unrolled(inputs, ST, max_iter):
    """``outer_loop`` as one function of tensors: the prologue,
    ``max_iter`` iterations with no exit read (``_iterations``), the
    call's live iterations added to ``iterations_on`` and the epilogue.
    Capture-safe: the rate loop inside the segment program's one graph
    (``Layer3SegmentEncoder._segment``); op by op it equals ``_eager``."""
    state, best = _prologue(ST=ST, **inputs)
    _iterations(state, best, ST, max_iter)
    iterations_on(inputs["xr"].device).add_(state["iters"])
    return _epilogue(inputs["xr"], best, state["qss0"], inputs["block_type"],
                     inputs["is_short_block"])


class Then(NamedTuple):
    """What runs on ``outer_loop``'s outputs in the same call:
    ``fn(outputs, inputs)`` (the loop's inputs by name), a dict of
    tensors, is returned in place of the outputs.  On the card it is
    captured with the loop (one graph per loop key and `key`) and
    replays inside the profiler span `span`."""
    key: tuple
    fn: Callable
    span: str


def _eager(inputs, ST, max_iter, then=None):
    """The three parts, and `then`, dispatched op by op; the iterations
    stop where ``jaxloop``'s exit condition, read on the host, stops
    them."""
    state, best = _prologue(ST=ST, **inputs)
    it = 0
    while it < max_iter and any_on_host(~state["done"]):
        _iteration(state, best, ST)
        it += 1
    iterations_on(inputs["xr"].device).add_(state["iters"])
    out = _epilogue(inputs["xr"], best, state["qss0"], inputs["block_type"],
                    inputs["is_short_block"])
    return out if then is None else then.fn(out, inputs)


# ---------------------------------------------------------------------------
# the outer loop as CUDA graphs
# ---------------------------------------------------------------------------

#: captured rate loops kept at once (a stereo clip of one sample rate
#: makes 6 keys: 3 segment widths, each for the demand and final encode)
GRAPH_CACHE_SIZE = 16
#: the process's captured rate loops (``graphs.GraphCache``)
GRAPHS = graphs.GraphCache(GRAPH_CACHE_SIZE)
#: graph captures and replays by stage (``graphs.graph_counts``)
graph_counts = graphs.graph_counts


#: the iterations' sums by device (``iterations_on``)
_ITERATIONS = {}


def iterations_on(device):
    """The iterations of every ``outer_loop`` call on `device` in which
    some lane was live, summed on the device: an int64 () tensor that the
    calls add to without a wait."""
    dev = graphs.canonical_device(device)
    if dev not in _ITERATIONS:
        _ITERATIONS[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return _ITERATIONS[dev]


def iterations(device):
    """``iterations_on(device)`` read on the host (a wait)."""
    return int(iterations_on(device))


def reset_iterations():
    for acc in _ITERATIONS.values():
        acc.zero_()


def _prologue_outputs(inputs, ST):
    """``_prologue`` as a captured program's results: dict(state, best)."""
    state, best = _prologue(ST=ST, **inputs)
    return dict(state=state, best=best)


def _loop_outputs(entry):
    """The epilogue's outputs over an entry's static state and inputs."""
    inp, pro = entry.inputs, entry.outputs["prologue"]
    return _epilogue(inp["xr"], pro["best"], pro["state"]["qss0"],
                     inp["block_type"], inp["is_short_block"])


def _run_loop(inputs, ST, max_iter, record, refs=(), then=None):
    """The captured loop's host side, on the current stream, as three
    programs of one ``GRAPHS`` entry: ``graphs.run`` of the prologue
    (stage "prologue"; its results, the static state and best, are the
    entry's ``outputs["prologue"]``), then ``graphs.run_next`` of
    ``max_iter`` iterations (``_iterations``, stage "iteration"), which
    update that state and best in place, and, given `then`, of its
    continuation (stage "emission", a graph for each ``then.key``,
    replayed inside the span ``then.span``).  On first sight of a key or
    continuation each runs eagerly before its capture (the warm-up: its
    results are this call's); otherwise each replays once.  No exit is
    read on the host.  The call's live iterations are added to
    ``iterations_on`` before the continuation.  Returns (entry, the
    entries the cache dropped, then's static outputs or None); the
    entry's outputs hold this call's results until the next call of its
    key."""
    entry, dropped = graphs.run(
        GRAPHS, (graphs.key_of(inputs, ST), max_iter), "prologue", inputs,
        lambda static: _prologue_outputs(static, ST), record,
        (dict(ST),) + tuple(refs))
    pro = entry.outputs["prologue"]

    def iterate():
        _iterations(pro["state"], pro["best"], ST, max_iter)
        return {}

    graphs.run_next(entry, "iteration", iterate, record)
    iterations_on(inputs["xr"].device).add_(pro["state"]["iters"])
    if then is None:
        return entry, dropped, None
    out = graphs.run_next(
        entry, "emission", lambda: then.fn(_loop_outputs(entry),
                                           entry.inputs),
        record, name=("emission", then.key), refs=(then,), span=then.span)
    return entry, dropped, out


def _graphed(inputs, ST, max_iter, then=None):
    """``outer_loop`` on a CUDA device: ``_run_loop`` on the graph stream
    (which first waits for the caller's), then on the caller's stream the
    epilogue on clones of best, or clones of then's outputs."""
    dev = inputs["xr"].device

    def body():
        entry, dropped, out = _run_loop(
            inputs, ST, max_iter, graphs.cuda_graph(dev),
            search.device_buffers(dev), then)
        return (entry, out), dropped

    def keep(res):
        entry, out = res
        if out is not None:
            return {k: v.clone() for k, v in out.items()}
        pro = entry.outputs["prologue"]
        best = {k: v.clone() for k, v in pro["best"].items()}
        return _epilogue(inputs["xr"], best, pro["state"]["qss0"].clone(),
                         inputs["block_type"], inputs["is_short_block"])

    return graphs.on_stream(dev, body, keep)


def _inputs(xr, budget, ratio_l, ratio_s, is_short_block, block_type,
            sf_fix_mask, sf_fix_val, sf_skip_mask, qss_lo):
    return dict(xr=xr, budget=budget, ratio_l=ratio_l, ratio_s=ratio_s,
                is_short_block=is_short_block, block_type=block_type,
                sf_fix_mask=sf_fix_mask, sf_fix_val=sf_fix_val,
                sf_skip_mask=sf_skip_mask, qss_lo=qss_lo)


@span("outer_loop")
def outer_loop(xr, budget, ratio_l, ratio_s, is_short_block, block_type,
               ST, max_iter=6, sf_fix_mask=None, sf_fix_val=None,
               sf_skip_mask=None, qss_lo=None, then=None):
    """Distortion-control loop (loop.c:415-558), batched & masked.

    xr (G, 576) float32 signed spectrum; budget (G,) float32 max bits.
    sf_fix_mask/sf_fix_val (G, 21): long sfbs whose scalefactors are
    FIXED (scfsi); sf_skip_mask (G, 21): fixed bands not transmitted.
    qss_lo: warm lower bound for the initial bisection.
    Returns dict of per-granule coding decisions (see jaxloop.outer_loop).
    then: a ``Then`` continuation; the call returns ``then.fn(outputs,
    inputs)`` in place of the outputs.

    On a CUDA tensor the prologue and the `max_iter` iterations, unrolled,
    replay one CUDA graph each, captured on the key's first call
    (``GRAPHS``), and so does `then` after the last iteration, reading
    the loop's static tensors (stage "emission"); nothing waits on the
    host, and a capture or replay error raises.  On any other device it
    is ``outer_loop_eager``."""
    inputs = _inputs(xr, budget, ratio_l, ratio_s, is_short_block,
                     block_type, sf_fix_mask, sf_fix_val, sf_skip_mask,
                     qss_lo)
    if xr.device.type == "cuda":
        return _graphed(inputs, ST, max_iter, then)
    return _eager(inputs, ST, max_iter, then)


@span("outer_loop")
def outer_loop_eager(xr, budget, ratio_l, ratio_s, is_short_block,
                     block_type, ST, max_iter=6, sf_fix_mask=None,
                     sf_fix_val=None, sf_skip_mask=None, qss_lo=None,
                     then=None):
    """``outer_loop`` with the same prologue, iterations, epilogue and
    `then` dispatched op by op on every device: what the CPU runs, and on
    the card the yardstick of the captured loop.  A run whose searches
    are swapped for other Python (the plain searches sync on the host)
    must call this form: a graph replays kernels, not Python."""
    return _eager(_inputs(xr, budget, ratio_l, ratio_s, is_short_block,
                          block_type, sf_fix_mask, sf_fix_val, sf_skip_mask,
                          qss_lo), ST, max_iter, then)
