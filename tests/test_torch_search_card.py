"""K3 on the card: the stepsize searches' CUDA kernel against the lockstep
plain searches, equal on qss, bits, every count row and the evaluation
counts, with status 0, on the cases of tests/test_torch_search_model.py
and at the main path's segment widths, at the width the launch picks and
at every width forced through the wrapper; and the evaluations it ran
(``runs``) against ``model_search``, the granule-level model of its
schedule that tests/test_torch_search_model.py holds to the plain
searches on the CPU.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker
and skip without a card.  This file imports no jax (the card's machine
has none); run it there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_search_card.py
"""
from unittest import mock

import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop, search
from mp3tpu_torch.tables import mpeg
from test_torch_bits_at_card import kernel_args, random_batch

torch.set_num_threads(1)

BUDGETS = (0.0, 50.0, 300.0, 1200.0, 4095.0)
#: (name, search, MPEG version)
CASES = (("stepsize", "stepsize", mpeg.MPEG1),
         ("stepsize_qss_lo", "stepsize", mpeg.MPEG1),
         ("stepsize_lsf", "stepsize", mpeg.MPEG2_LSF),
         ("stepsize_cap", "stepsize", mpeg.MPEG1),
         ("walk", "walk", mpeg.MPEG1),
         ("walk_lsf", "walk", mpeg.MPEG2_LSF),
         ("walk_cap", "walk", mpeg.MPEG1))


def search_case(name, G, seed):
    """A search batch as numpy arrays: (kind, version, xr75p, budget,
    start, qss_lo, is_short, is_short_block).  ``random_batch``'s mixed
    long, short and start/stop granules (silent ones, loud ones past IXMAX
    at the first mids) under budgets 0, 50, 300, 1200 and 4095; start is
    qanf for the stepsize search and a warm start for the walk.
    "walk_cap" walks a loud spectrum with budget 0 from -100, so that its
    lanes stop at the 40-step cap (a few silent lanes stop at once);
    "stepsize_cap" searches a louder one with budget 0: no bisection mid
    fits, and the walk from QMAX stops at the cap (silent lanes fit at
    the first mid)."""
    kind, version = {c[0]: c[1:] for c in CASES}[name]
    rng = np.random.RandomState(seed)
    xr75, _, is_short, wsf = random_batch(seed, G)
    xr75[5::11] = 0.0                          # silent granules
    budget = rng.choice(BUDGETS, G).astype(np.float32)
    qss_lo = None
    if kind == "stepsize":
        start = rng.randint(-170, -69, G).astype(np.float32)
        if name == "stepsize_qss_lo":
            qss_lo = rng.randint(-140, 30, G).astype(np.float32)
        elif name == "stepsize_cap":
            xr75 = (1e5 * (1.0 + rng.rand(G, 576))).astype(np.float32)
            xr75[::7] = 0.0
            budget = np.zeros(G, np.float32)
    elif name == "walk_cap":
        xr75 = (1.0 + 50.0 * rng.rand(G, 576)).astype(np.float32)
        xr75[::7] = 0.0
        budget = np.zeros(G, np.float32)
        start = np.full(G, -100.0, np.float32)
    else:
        start = rng.randint(-100, 60, G).astype(np.float32)
    return kind, version, xr75, budget, start, qss_lo, is_short, wsf


def case_args(case, device):
    """The search's arguments on `device`: (kind, args, kwargs)."""
    kind, version, xr75, budget, start, qss_lo, is_short, wsf = case
    xr75p, start_t, short_t, wsf_t, ST = kernel_args(xr75, start, is_short,
                                                     wsf, device, version)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    kwargs = {} if qss_lo is None else {"qss_lo": t(qss_lo)}
    return kind, (xr75p, t(budget), start_t, short_t, wsf_t, ST), kwargs


def run_search(kind, args, kwargs, plain=False, width=None):
    """(qss, bits, counts) of K3's wrapper (at `width` warps a granule,
    if given), or of the plain search."""
    if plain:
        fn = loop.search_stepsize_plain if kind == "stepsize" \
            else loop.search_walk_plain
        return fn(*args, **kwargs)
    fn = search.search_stepsize if kind == "stepsize" else search.search_walk
    return fn(*args, **kwargs, width=width)


def on_table(q):
    """The status rule: an integer stepsize in the factor table's range."""
    q = np.asarray(q, np.float32)
    return bool(np.all((q == np.floor(q)) & (q >= search.STEP_LO)
                       & (q <= search.STEP_HI)))


def table_quantize(xr75, qss):
    """loop.quantize_pow75 with K3's factor: the table entry of qss."""
    assert on_table(qss.cpu().numpy()), qss
    tab = search._istep_table(xr75.device)
    istep75 = tab[(qss - search.STEP_LO).long()][:, None]
    return loop._to_ix(xr75 * istep75 - 0.0946 + 0.5)


# ---- K3's schedule, granule by granule (csrc/bits_at.cu search_kernel)

F32 = np.float32
#: widths the tests force: one warp, a ladder of 2 (its tree is 1 node),
#: trees of 1, 2 and 3 levels (3, 4 and 7 warps)
WIDTHS = (1, 2, 3, 4, 7)


def _mid(lo, hi):
    return F32(np.floor(F32(F32(lo + hi) * F32(0.5))))


def _nan_max(a, b):
    return a if a != a else (b if b != b else max(a, b))


def _tree_mid(node, lo, hi, lo_known, hi_known):
    """tree_mid: (the node's mid, whether a warp evaluates it)."""
    level = (node + 1).bit_length() - 1
    path = node + 1 - (1 << level)
    taken = True
    for lev in range(level - 1, -1, -1):
        fits = (path >> lev) & 1
        mid = _mid(lo, hi)
        if (lo_known and mid == lo and fits) or \
                (hi_known and mid == hi and not fits):
            taken = False
        if fits:
            hi, hi_known = mid, True
        else:
            lo, lo_known = mid, True
    mid = _mid(lo, hi)
    return mid, taken and not (lo_known and mid == lo) \
        and not (hi_known and mid == hi)


def model_granule(walk, at, b, start, qss_lo, width, n_bisect=8,
                  max_steps=40):
    """One granule's search as the `width` warps of search_kernel run it,
    pass by pass.  at(q) is the granule's evaluation at q (a dict whose
    "bits" is a float32).  Returns dict(qss, rows: at(qss), evals, runs,
    passes, bisect_passes, met: the stepsizes evaluated, mid_fit: whether
    a bisection mid fitted)."""
    qss, kept = F32(start), None
    floor_q = lo = F32(-210.0)
    hi = F32(45.0)
    lo_known = hi_known = below_known = False
    below = F32(0.0)
    left = steps = first = down = 0
    phase = "walk"
    if not walk:
        floor_q = _nan_max(qss, F32(-210.0))
        lo = floor_q if qss_lo is None else _nan_max(floor_q, F32(qss_lo))
        left, phase = n_bisect, "bisect"
    depth_max = (width + 1).bit_length() - 1
    runs = passes = bisect_passes = 0
    met = []
    while True:
        cnt = 0
        if phase == "bisect":
            if left == 0:
                qss = hi
                phase = "down" if hi_known else "walk"
                continue
            cnt = (1 << min(depth_max, left)) - 1
        elif phase == "walk":
            cnt = min(width, max_steps - steps - first + 1)
        elif phase == "down":
            q = qss
            while cnt < min(width, 3 - down):
                q = F32(q - F32(1.0))
                if not q >= floor_q or (below_known and q == below) or \
                        (lo_known and q == lo):
                    break
                cnt += 1
            if cnt == 0:
                phase = "done"
        if phase == "done":
            break
        x = [None] * cnt
        for sub in range(cnt):
            if phase == "bisect":
                q, active = _tree_mid(sub, lo, hi, lo_known, hi_known)
            else:
                active, q = True, qss
                for _ in range(first + sub if phase == "walk" else sub + 1):
                    q = F32(q + F32(1.0)) if phase == "walk" \
                        else F32(q - F32(1.0))
            if active:
                x[sub] = at(q)
                met.append(q)
                runs += 1
        passes += 1
        if phase == "bisect":
            bisect_passes += 1
            depth, node = min(depth_max, left), 0
            for _ in range(depth):
                mid = _mid(lo, hi)
                if lo_known and mid == lo:
                    fits = False
                elif hi_known and mid == hi:
                    fits = True
                else:
                    fits = bool(x[node]["bits"] <= b)
                    if fits:
                        kept = x[node]
                if fits:
                    hi, hi_known = mid, True
                else:
                    lo, lo_known = mid, True
                node = 2 * node + (2 if fits else 1)
            left -= depth
        elif phase == "walk":
            r = qss
            if first:
                below, below_known, r = qss, True, F32(qss + F32(1.0))
            j = 0
            while True:
                kept = x[j]
                if not x[j]["bits"] > b or j + 1 == cnt:
                    break
                below, below_known = r, True
                r = F32(r + F32(1.0))
                j += 1
            qss = r
            steps += first + j
            first = 1
            if not x[j]["bits"] > b or steps >= max_steps:
                phase = "done" if walk else "down"
        else:
            r, j = qss, 0
            while j < cnt:
                r = F32(r - F32(1.0))
                if not x[j]["bits"] <= b:
                    break
                qss, kept = r, x[j]
                j += 1
            down += j
            if j < cnt or down == 3:
                phase = "done"
    evals = steps + 2 if walk else n_bisect + 5 + steps
    return dict(qss=qss, rows=kept, evals=evals, runs=runs, passes=passes,
                bisect_passes=bisect_passes, met=met,
                mid_fit=walk or hi_known)


def batch_evaluations(args):
    """at(g, q): granule g's evaluation at stepsize q.  Each stepsize is
    evaluated once for the whole batch, by bits_at_plain with the table's
    factor, and kept (an evaluation depends on its granule alone)."""
    xr75p, _, start, short, sblk, ST = args
    cache = {}

    def at(g, q):
        q = float(q)
        if q not in cache:
            with mock.patch.object(loop, "quantize_pow75", table_quantize):
                c = K.bits_at_plain(xr75p, torch.full_like(start, q), short,
                                    sblk, ST)
            cache[q] = {k: v.cpu() for k, v in c.items()}
        rows = {k: v[g:g + 1] for k, v in cache[q].items()}
        rows["bits"] = F32(cache[q]["bits"][g])
        return rows
    return at


def model_search(kind, args, kwargs, width, n_bisect=8, max_steps=40,
                 at=None):
    """model_granule over a batch, on batch_evaluations(args) (or `at`).
    Returns dict(qss, bits, c: the counts with evals and runs, and per
    granule the other keys of model_granule as lists)."""
    budget, start = args[1].cpu().numpy(), args[2].cpu().numpy()
    qss_lo = kwargs.get("qss_lo")
    qss_lo = None if qss_lo is None else qss_lo.cpu().numpy()
    at = at or batch_evaluations(args)
    outs = []
    for g in range(len(budget)):
        outs.append(model_granule(
            kind == "walk", lambda q, g=g: at(g, q), budget[g], start[g],
            None if qss_lo is None else F32(qss_lo[g]), width, n_bisect,
            max_steps))
    keys = [k for k in outs[0]["rows"] if k != "bits"] if outs else []
    c = {k: torch.cat([o["rows"][k] for o in outs]) for k in keys}
    c["bits"] = torch.tensor([o["rows"]["bits"] for o in outs],
                             dtype=torch.float32)
    for k in ("evals", "runs"):
        c[k] = torch.tensor([o[k] for o in outs], dtype=torch.int32)
    res = {k: [o[k] for o in outs] for k in
           ("passes", "bisect_passes", "met", "mid_fit")}
    return dict(res, qss=torch.tensor([o["qss"] for o in outs],
                                      dtype=torch.float32),
                bits=c["bits"], c=c)


def search_mismatches(got, want):
    """The outputs where two search results differ (dtype, shape or any
    value): "qss", "bits" and every count of the plain search's dict."""
    pairs = [("qss", got[0], want[0]), ("bits", got[1], want[1])]
    pairs += [(k, got[2].get(k), v) for k, v in want[2].items()]
    return [k for k, a, b in pairs
            if a is None or a.dtype != b.dtype or a.shape != b.shape
            or not torch.equal(a, b)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _check(case, card, width=None):
    """K3 (at `width`, or the launch's pick) against the plain search on
    every output, status 0, one launch; returns K3's result and the
    case's (kind, args, kwargs)."""
    kind, args, kwargs = case_args(case, card)
    before = search.launches
    got = run_search(kind, args, kwargs, width=width)
    torch.cuda.synchronize()
    assert search.launches == before + 1
    want = run_search(kind, args, kwargs, plain=True)
    assert not search_mismatches(got, want)
    assert not bool(got[2]["status"].any())
    return got, (kind, args, kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_search_matches_plain_on_card(card, name):
    got, case = _check(search_case(name, 256, 41), card)
    if name.endswith("cap"):
        cap = 42 if name == "walk_cap" else 53
        assert int((got[2]["evals"] == cap).sum()) > 200
    # the launch's pick ran the model's schedule at that width
    m = model_search(*case, search.plan(256)["width"])
    assert torch.equal(got[2]["runs"].cpu(), m["c"]["runs"])


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_search_matches_plain_and_model_at_forced_widths(card, name, width):
    """Every width gives the plain search's results, and runs the
    evaluations the model of its schedule runs."""
    got, case = _check(search_case(name, 256, 41), card, width)
    m = model_search(*case, width)
    assert torch.equal(got[2]["runs"].cpu(), m["c"]["runs"])
    if width == 1:
        assert bool((got[2]["runs"] <= got[2]["evals"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("G", [512, 4096, 4099])
def test_search_matches_plain_at_widths(card, G):
    _check(search_case("stepsize", G, G), card)
    _check(search_case("walk", G, G + 1), card)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 3])
def test_search_past_the_grid_shares_granules_out(card, width):
    """A batch with more granules than the grid holds groups: the groups
    take their granules from the counter, which the kernel leaves at
    zero for the next launch."""
    G = 9000
    assert G > search.plan(G, width)["blocks"] * search.plan(G, width)[
        "groups"]
    for name in ("stepsize", "walk"):
        _, (_, args, _) = _check(search_case(name, G, 77), card, width)
        assert not bool(search._counter(args[0].device).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_baseline_matches_plain_on_card(card, name):
    """K3's first design, kept as the baseline: the plain search's results,
    counted apart from K3."""
    kind, args, kwargs = case_args(search_case(name, 256, 41), card)
    fn = search.baseline_stepsize if kind == "stepsize" \
        else search.baseline_walk
    before = (search.launches, search.baseline_launches)
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert (search.launches, search.baseline_launches) == (before[0],
                                                           before[1] + 1)
    assert "runs" not in got[2]
    assert not search_mismatches(got, run_search(kind, args, kwargs,
                                                 plain=True))
    assert not bool(got[2]["status"].any())


@pytest.mark.cuda
def test_plan_fills_the_card_at_512_lanes(card):
    """At the main path's 512 lanes the launch spreads over the SMs; a
    batch that fills the card runs one warp a granule."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for width in (None,) + WIDTHS:
        p = search.plan(512, width)
        assert p["threads"] == 32 * p["width"] * p["groups"] <= 512
        assert p["blocks"] * p["groups"] >= 512
        assert p["blocks"] >= min(sms, 512 // p["groups"])
    assert search.plan(512)["width"] == 3
    assert search.plan(65536)["width"] == 1


@pytest.mark.cuda
def test_loop_searches_launch_k3_not_bits_at(card):
    kind, args, kwargs = case_args(search_case("stepsize", 64, 5), card)
    before = (search.launches, K.bits_at.launches, search.baseline_launches)
    qss, bits, c = loop.search_stepsize(*args)
    loop.search_walk(args[0], args[1], qss, *args[3:])
    assert (search.launches, K.bits_at.launches, search.baseline_launches) \
        == (before[0] + 2, before[1], before[2])
    assert bits is c["bits"]


@pytest.mark.cuda
def test_search_of_no_granule_launches_nothing(card):
    kind, args, kwargs = case_args(search_case("walk", 0, 6), card)
    before = search.launches
    qss, bits, c = search.search_walk(*args)
    assert search.launches == before
    assert qss.shape == bits.shape == c["evals"].shape == (0,)
