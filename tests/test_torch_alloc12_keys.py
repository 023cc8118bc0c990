"""K5's design (``csrc/alloc12.cu`` ``alloc12_kernel``) as a lane-level
numpy model, held on the CPU to what K5 replaces.

The model: each candidate's float64 MNR as a uint64 order key (every NaN 0,
-0.0 as +0.0, else the sign-flip map), each lane's better key (channel 0 on
a tie), the warp's argmin in two halves (``__reduce_min_sync`` on the high
words, then on the low words of the lanes that hold that high word, the
others offering 0xffffffff; a ballot of the lanes that hold both; ``__ffs``),
the exit read from the smallest key in every lane, the winner's step priced
in integers against the bits left, its one broadcast (the bits taken), and
Layer I's limit recomputed when lane 0's channel-0 allocation moves (lane
0 shuffles it to every lane on the steps it wins).

Held: the key order to ``np.argmin`` over 64 candidates (hypothesis, on rows
drawn from NaN of both signs and several payloads, +-0.0, +-inf, 1e30,
subnormals and repeated values, and pairwise over a list of those values);
``model_frame`` to ``runtime/alloc12`` (the plain version), the
``numpy_ref/layer12`` oracles (rows without NaN, as
tests/test_torch_alloc12_model.py holds the first design's model) and the
first design's model's steps, on every ``alloc_cases()`` case and the JAX
package's analysis of the fixtures; ``kernel_tables``' check of the integer
design; ``kernel_report``'s reading of a ptxas report.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mp3tpu_torch.ops import alloc12 as A12
from mp3tpu_torch.runtime import alloc12 as host
from mp3tpu_torch.tables import mpeg
from test_torch_layer12_card import (alloc_cases, lockstep_rounds, plain_of,
                                     rung)
from test_torch_layer12_card import model_alloc as first_design_alloc

torch.set_num_threads(1)

LANES = np.arange(32)
SIGN = np.uint64(1 << 63)
LOW = np.uint64(0xffffffff)
INT32 = (-2 ** 31, 2 ** 31 - 1)

# ---------------------------------------------------------------------------
# the order key and the warp's argmin
# ---------------------------------------------------------------------------


def flip(x):
    """The sign-flip map of float64 values to uint64 keys."""
    u = np.asarray(x, np.float64).view(np.uint64)
    return np.where((u >> np.uint64(63)) != 0, ~u, u | SIGN)


def order_key(x):
    """numpy's argmin order as a uint64 key: every NaN 0, -0.0 as +0.0,
    else the sign-flip map."""
    x = np.asarray(x, np.float64)
    x = np.where(x == 0.0, 0.0, x)
    return np.where(np.isnan(x), np.uint64(0), flip(x))


KEY_INF = order_key(host.INF)


def limit_key(lim):
    """Layer I's limit np.minimum(lim, INF) as a key (NaN: 0)."""
    lim = np.float64(lim)
    return order_key(lim if np.isnan(lim) or lim < host.INF else host.INF)


def lane_best(k0, k1):
    """Each lane's better key and its channel (channel 0 on a tie)."""
    second = k1 < k0
    return np.where(second, k1, k0), second


def warp_min(kb):
    """The two-half reduction of the lanes' keys: (the smallest key, the
    lowest lane that holds it)."""
    hi, lo = kb >> np.uint64(32), kb & LOW
    mhi = hi.min()                                   # redux.sync.min.u32
    mlo = np.where(hi == mhi, lo, LOW).min()         # redux.sync.min.u32
    ballot = 0
    for lane in np.flatnonzero((hi == mhi) & (lo == mlo)):
        ballot |= 1 << int(lane)                     # vote.ballot
    win = (ballot & -ballot).bit_length() - 1        # __ffs - 1
    return (mhi << np.uint64(32)) | mlo, win


def key_argmin(values):
    """The flat index (2 sb + ch) the warp picks among 64 candidates."""
    v = np.asarray(values, np.float64).reshape(32, 2)
    kb, second = lane_best(order_key(v[:, 0]), order_key(v[:, 1]))
    _, win = warp_min(kb)
    return 2 * win + int(second[win])


def nan(sign, payload):
    bits = (0xFFF0000000000000 if sign else 0x7FF0000000000000) | payload
    return np.array([bits], np.uint64).view(np.float64)[0]


#: NaN of both signs and several payloads, +-0.0, +-inf, INF, subnormals,
#: the smallest and largest normals, and a few ordinary values
SPECIAL = [nan(0, 1 << 51), nan(1, 1 << 51), nan(0, 1), nan(1, 12345),
           0.0, -0.0, np.inf, -np.inf, host.INF, -host.INF, 5e-324,
           -5e-324, 2.2250738585072014e-308, -2.2250738585072014e-308,
           1.7976931348623157e308, -1.7976931348623157e308, 1.0, -1.0,
           12.5, -12.5]

values = st.one_of(st.sampled_from(SPECIAL),
                   st.floats(allow_nan=False, width=64),
                   st.sampled_from([3.0, -7.5, 0.5]))


@settings(max_examples=400, deadline=None)
@given(st.lists(values, min_size=64, max_size=64))
def test_the_key_argmin_is_numpys(row):
    assert key_argmin(row) == int(np.argmin(np.array(row, np.float64)))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from(SPECIAL[4:]), min_size=64, max_size=64))
def test_the_key_argmin_is_numpys_on_special_values_without_nan(row):
    assert key_argmin(row) == int(np.argmin(np.array(row, np.float64)))


#: (i, j): two flat positions, in one lane (both orders) and in two lanes
PLACES = [(0, 1), (1, 0), (6, 7), (2, 3), (3, 2), (0, 63), (63, 0), (9, 40)]


def test_the_key_order_pairwise_over_the_special_values():
    for a in SPECIAL:
        for b in SPECIAL:
            # the keys order a pair as numpy's argmin does
            ka, kb = order_key(a), order_key(b)
            assert (np.argmin([a, b]) == 0) == (ka <= kb), (a, b)
            assert (np.argmin([b, a]) == 0) == (kb <= ka), (a, b)
            for i, j in PLACES:
                row = np.full(64, b)
                row[i] = a
                assert key_argmin(row) == int(np.argmin(row)), (a, b, i)
                row = np.full(64, host.INF)
                row[i], row[j] = a, b
                assert key_argmin(row) == int(np.argmin(row)), (a, b, i, j)


def test_the_limit_key():
    assert limit_key(np.nan) == 0
    assert limit_key(np.inf) == KEY_INF == limit_key(host.INF)
    assert limit_key(2.0) == order_key(2.0)
    # nothing is below a NaN limit, and a value below the limit is
    assert not np.uint64(1) < limit_key(np.nan)
    assert order_key(1.5) < limit_key(2.0) <= order_key(2.0)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def tables(layer, table):
    """K5's shared tables as the kernel builds them from
    ``kernel_tables``, indexed [k][sb]: snr_after, the ladder, the cost
    and a step's sample bits from ba = k (ints), and maxba, nbal, the
    ladder's bound, the jsbounds and 6 * SFS_PER_SCFSI."""
    dtab, itab = A12.kernel_tables(layer, table)
    cost = dtab[512:1024].reshape(32, 16)
    stp = np.stack([cost[:, min(k + 1, 15)] - (cost[:, k] if k else 0.0)
                    for k in range(16)])
    return dict(snr=dtab[:512].reshape(32, 16).T,
                lad=dtab[1024:1536].reshape(32, 16),
                cost=cost.T.astype(np.int64), stp=stp.astype(np.int64),
                sfs6=dtab[1536:1540].astype(np.int64), maxba=itab[:32],
                nbal=itab[32:64], bound=itab[64:96], jsb=itab[96:100])


def nonoise_bits(jb, k, scf, t, layer, nch, sblimit, ep):
    """bits_for_nonoise at jsbound jb: the lanes' integer bits, then the
    warp's sum (__reduce_add_sync)."""
    lanes = np.zeros(32, np.int64)
    for sb in range(32):
        js = sb >= jb
        both, second = nch == 2 and js, nch == 2 and not js
        k0, k1 = k[0][sb], k[1][sb]
        ke0 = max(k0, k1) if both else k0
        if layer == 1:
            lanes[sb] = ((ke0 + 1) * 12 + 6 * (nch if js else 1)
                         if ke0 > 0 else 0) + \
                ((k1 + 1) * 12 + 6 if second and k1 > 0 else 0)
            if sb == 0:
                lanes[sb] += 32 + 4 * (jb * nch + (32 - jb))
            continue
        if sb < sblimit:
            sel = 4 if both else 2
            s0, s1 = t["sfs6"][scf[0][sb]], t["sfs6"][scf[1][sb]]
            sc0, sc1 = s0 + (s1 if both else 0), s1 + (s0 if both else 0)
            lanes[sb] = (t["cost"][ke0, sb] + sel + sc0 if ke0 > 0 else 0) \
                + (t["cost"][k1, sb] + sel + sc1 if second and k1 > 0
                   else 0) + t["nbal"][sb] * (1 if js else nch)
        if sb == 0:
            lanes[sb] += 32 + (16 if ep else 0)
    total = int(lanes.sum())
    assert INT32[0] <= total <= INT32[1]
    return total


def model_frame(smr, scf, layer, table, nch, sblimit, adb, error_protection,
                joint, mode):
    """One frame as K5's warp walks it: smr (2, 32) float64, scf (2, 32)
    ints or None.  Returns {"ba": (2, 32), "adb_left", "mode",
    "mode_ext", "jsbound", "steps"}."""
    t = tables(layer, table)
    ep = bool(error_protection)
    scf = np.zeros((2, 32), np.int64) if scf is None else np.asarray(scf)
    smr = np.asarray(smr, np.float64)

    full = 32 if layer == 1 else sblimit
    jsbound, mode_ext = full, 0
    if joint:
        k = [[rung(t["lad"][sb], t["bound"][sb], smr[ch][sb])
              for sb in range(32)] for ch in range(2)]
        args = (k, scf, t, layer, nch, sblimit, ep)
        needs = nonoise_bits(full, *args) > adb
        mode = mpeg.MODE_JOINT if needs else mpeg.MODE_STEREO
        if needs:
            for ext in (3, 2, 1, 0):
                jsbound, mode_ext = int(t["jsb"][ext]), ext
                if not nonoise_bits(jsbound, *args) > adb:
                    break

    ba, left, steps = model_walk(smr, scf, jsbound, t, layer, nch, sblimit,
                                 adb, ep)
    return dict(ba=ba, adb_left=left, mode=mode, mode_ext=mode_ext,
                jsbound=jsbound, steps=steps)


def model_walk(smr, scf, jsbound, t, layer, nch, sblimit, adb, ep):
    """The greedy walk of one frame at `jsbound` (t: ``tables``): (ba
    (2, 32), the bits left, the steps)."""
    js = LANES >= jsbound
    copy = (nch == 2) & js
    sbl = 32 if layer == 1 else sblimit
    bbal = (4 * (jsbound * nch + (32 - jsbound)) if layer == 1 else
            int(np.where(LANES < sbl, t["nbal"] * np.where(js, 1, nch),
                         0).sum()))
    left = adb - bbal - (16 if ep else 0) - 32
    if layer == 1:
        fe = np.stack([6 * np.where(js, nch, 1)] * 2)
    else:
        a, b = t["sfs6"][scf[0]], t["sfs6"][scf[1]]
        fe = np.stack([2 + a + np.where(copy, 2 + b, 0),
                       2 + b + np.where(copy, 2 + a, 0)])
    key = np.stack([np.where(LANES < sbl, order_key(-smr[0]), KEY_INF),
                    np.where((LANES < sbl) & (nch == 2), order_key(-smr[1]),
                             KEY_INF)])
    ba = np.zeros((2, 32), np.int64)
    klim = limit_key(-smr[0][0] + 1.0) if layer == 1 else KEY_INF
    steps = 0
    # a NaN candidate (key 0) would be the first step's argmin and end the
    # frame: a frame that holds one walks no step (__any_sync)
    nan = bool((key == 0).any())
    while not nan:
        kb, second = lane_best(key[0], key[1])
        kmin, win = warp_min(kb)
        assert kmin != 0                     # no step makes a NaN
        if kmin >= klim:                     # every lane, the same
            break
        steps += 1
        # the winning lane
        sb, pch = win, int(second[win])
        cur = int(ba[pch][sb])
        assert cur == 0 or cur < t["maxba"][sb] <= 15
        total = int(t["stp"][cur][sb]) + (int(fe[pch][sb]) if cur == 0
                                          else 0)
        snr = t["snr"][cur + 1][sb]
        fits = left >= total
        nb = cur + int(fits)
        live = fits and nb < t["maxba"][sb]
        news = []
        for ch in (pch, 1 - pch):
            m = snr - smr[ch][sb]
            if live and (ch == pch or copy[sb]):
                # the step's float64 is never a NaN or a -0.0: its key is
                # the sign-flip map alone
                assert not np.isnan(m) and not (m == 0 and np.signbit(m))
                assert flip(m) == order_key(m)
            news.append(flip(m) if live else KEY_INF)
        key[pch][sb], ba[pch][sb] = news[0], nb
        if copy[sb]:
            key[1 - pch][sb], ba[1 - pch][sb] = news[1], nb
        # the broadcast: the bits taken, added in every lane
        taken = total if fits else 0
        left -= taken
        assert INT32[0] <= left <= INT32[1]
        if layer == 1 and win == 0:
            # lane 0's channel-0 allocation moves on its taken step, or on
            # either outcome of its channel 1 when it copies: lane 0
            # shuffles it to every lane, which recomputes the limit
            if (bool(copy[0]) if pch else fits):
                assert 0 <= ba[0][0] <= 15
                klim = limit_key(t["snr"][ba[0][0]][0] - smr[0][0] + 1.0)
    return ba, left, steps


def model_alloc(smr, scf, **kw):
    """``model_frame`` over (F, 2, 32) frames: numpy arrays of every
    output, int32 as K5 writes them."""
    frames = [model_frame(smr[f], None if scf is None else scf[f], **kw)
              for f in range(smr.shape[0])]
    return {k: np.array([fr[k] for fr in frames], np.int32)
            for k in A12.OUTPUTS + ("steps",)}


def check(smr, scf, kw):
    """The model == the plain version on every output, its steps == the
    first design's model's and + 1 == the lockstep rounds, and == the
    oracles on the rows without NaN."""
    from test_torch_alloc12_model import oracle_frame
    got = model_alloc(smr, scf, **kw)
    want = plain_of(smr, scf, kw)
    for k in A12.OUTPUTS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["steps"],
                                  first_design_alloc(smr, scf, **kw)["steps"])
    assert got["steps"].max() + 1 == lockstep_rounds(
        smr, scf, kw, want["jsbound"].astype(np.int64))
    for f in range(smr.shape[0]):
        if np.isnan(smr[f]).any():
            continue
        ba, left, mode, ext, jsb = oracle_frame(
            smr[f], None if scf is None else scf[f], **kw)
        np.testing.assert_array_equal(got["ba"][f], ba, err_msg=f"frame {f}")
        assert (got["adb_left"][f], got["mode"][f], got["mode_ext"][f],
                got["jsbound"][f]) == (left, mode, ext, jsb), f
    return got


CASES = alloc_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_model_equals_alloc12_and_the_oracles(case):
    label, smr, scf, kw = case
    check(smr, scf, kw)


def _jax_fixtures():
    from test_torch_layer12_card import FIXTURES
    return [(name, layer, mode, kbps, crc)
            for name, layer, mode, kbps, _ in FIXTURES[:6]
            for crc in (False, True)]


JAX_FIXTURES = _jax_fixtures()


@pytest.mark.parametrize("case", JAX_FIXTURES,
                         ids=[f"{c[0]}{'_crc' * c[4]}" for c in JAX_FIXTURES])
def test_model_on_the_fixtures_jax_analysis(case):
    from test_torch_alloc12_model import jax_analysis
    smr, scf, kw = jax_analysis(*case)
    got = check(smr, scf, kw)
    if kw["joint"] and case[0] == "l2_noise_j_128":
        assert (got["mode"] == mpeg.MODE_JOINT).any()


@pytest.mark.parametrize("jsbound", [0, 4, 16, 32])
def test_layer_one_limit_tracked_from_the_broadcasts(jsbound):
    """Layer I's limit follows lane 0's channel-0 allocation, through the
    joint copy too at jsbound 0 (which no Layer I mode_ext selects, so the
    walk is held to ``greedy_allocation`` at a forced jsbound): a loud or
    quiet subband 0, a signed zero there, the limit biting early."""
    t = tables(1, None)
    rng = np.random.RandomState(5 + jsbound)
    smr = np.round(rng.uniform(0, 60, (6, 2, 32)) * 2) / 2
    smr[:, 0, 0] = [-30.0, 80.0, 0.0, -0.0, 45.5, 12.0]
    smr[5, 1, 0] = 70.0
    steps = []
    for adb in (600, 3000, 12000):
        ba, left = host.greedy_allocation(
            smr, None, np.full(6, adb), np.full(6, jsbound), 1, None, 2,
            False)
        for f in range(6):
            got = model_walk(smr[f], np.zeros((2, 32), np.int64), jsbound,
                             t, 1, 2, 32, adb, False)
            np.testing.assert_array_equal(got[0], ba[f], err_msg=str(f))
            assert got[1] == left[f]
            steps.append(got[2])
    assert min(steps) < max(steps)


def test_both_wrappers_run_the_plain_version_on_the_cpu():
    """On a CPU tensor ``allocate`` runs the numpy code and launches
    nothing; another device is refused."""
    label, smr, scf, kw = CASES[4]
    args = (torch.as_tensor(smr), None if scf is None else
            torch.as_tensor(scf))
    want = A12.allocate_plain(*args, **kw)
    before = A12.launches
    got = A12.allocate(*args, **kw)
    for k in A12.OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    assert got["steps"] is None
    with pytest.raises(ValueError, match="unsupported device"):
        A12.allocate(args[0].to("meta"), None if scf is None else
                     args[1].to("meta"), **kw)
    assert A12.launches == before


# ---------------------------------------------------------------------------
# the integer design's premises and the ptxas report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer,table", [(1, None)] + [(2, t)
                                                       for t in range(5)])
def test_kernel_tables_hold_the_integer_design(layer, table):
    dtab, itab = A12.kernel_tables(layer, table)
    cost, sfs6 = dtab[512:1024], dtab[1536:1540]
    assert (cost == np.round(cost)).all() and (sfs6 == np.round(sfs6)).all()
    assert cost.max() <= 576 and sfs6.max() == 18
    assert 64 * (np.abs(cost).max() + 4 + 2 * sfs6.max()) < 2 ** 31
    # the kernel's step table prices every step as the plain code does
    t = tables(layer, table)
    for sb in range(32):
        for cur in range(int(t["maxba"][sb])):
            c = dtab[512 + 16 * sb:512 + 16 * sb + 16]
            want = c[min(cur + 1, 15)] - (0.0 if cur == 0 else c[cur])
            assert t["stp"][cur][sb] == want


def test_kernel_tables_refuse_what_the_integer_design_cannot_hold(
        monkeypatch):
    real = host._snr_ladder

    def doctored(change):
        def fn(layer, table):
            snr_after, cost, maxba, nbal = real(layer, table)
            snr_after, cost = snr_after.copy(), cost.copy()
            maxba = maxba.copy()
            change(snr_after, cost, maxba)
            return snr_after, cost, maxba, nbal
        return fn

    def half_bit(snr, cost, maxba):
        cost[3, 2] += 0.5

    def huge(snr, cost, maxba):
        cost[3, 2] = 2.0 ** 30

    def negative_zero(snr, cost, maxba):
        snr[0, 0] = -0.0

    def deep(snr, cost, maxba):
        maxba[0] = 16

    for change, match in ((half_bit, "not an integer"), (huge, "int32"),
                          (negative_zero, "signed"), (deep, "maxba")):
        monkeypatch.setattr(host, "_snr_ladder", doctored(change))
        with pytest.raises(AssertionError, match=match):
            A12.kernel_tables(2, 1)
    monkeypatch.setattr(host, "_snr_ladder", real)
    A12.kernel_tables(2, 1)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114alloc12_kernelILi2EEEvPKdPKiS2_S4_NS_6ParamsEPiS7_S7_S7_S7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114alloc12_kernelILi2EEEvPKdPKiS2_S4_NS_6ParamsEPiS7_S7_S7_S7_S7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 12704 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114alloc12_kernelILi1EEEvPKdPKiS2_S4_NS_6ParamsEPiS7_S7_S7_S7_S7_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114alloc12_kernelILi1EEEvPKdPKiS2_S4_NS_6ParamsEPiS7_S7_S7_S7_S7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 12704 bytes smem, 416 bytes cmem[0]
"""


def test_kernel_report_reads_each_design():
    got = A12.kernel_report(PTXAS)
    assert got == {
        "alloc12_kernel<2>": dict(registers=30, stack=0, spill_stores=0,
                                  spill_loads=0),
        "alloc12_kernel<1>": dict(registers=32, stack=0, spill_stores=0,
                                  spill_loads=0)}
    assert A12.kernel_report("ptxas info    : 0 bytes gmem\n") == {}
    with pytest.raises(ValueError):
        A12.kernel_report(PTXAS.replace("Used 30 registers", "Used"))
