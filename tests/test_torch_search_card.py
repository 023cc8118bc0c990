"""K3 on the card: the stepsize searches' CUDA kernel against the lockstep
plain searches, equal on qss, bits, every count row and the evaluation
counts, with status 0, on the cases of tests/test_torch_search_model.py
and at the main path's segment widths.

A CUDA kernel has no CPU mode, so these tests carry the `cuda` marker
and skip without a card.  This file imports no jax (the card's machine
has none); run it there without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_search_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop, search
from mp3tpu_torch.tables import mpeg
from test_torch_bits_at_card import kernel_args, random_batch

BUDGETS = (0.0, 50.0, 300.0, 1200.0, 4095.0)
#: (name, search, MPEG version)
CASES = (("stepsize", "stepsize", mpeg.MPEG1),
         ("stepsize_qss_lo", "stepsize", mpeg.MPEG1),
         ("stepsize_lsf", "stepsize", mpeg.MPEG2_LSF),
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
    lanes stop at the 40-step cap (a few silent lanes stop at once)."""
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


def run_search(kind, args, kwargs, plain=False):
    """(qss, bits, counts) of K3's wrapper, or of the plain search."""
    if kind == "stepsize":
        fn = loop.search_stepsize_plain if plain else search.search_stepsize
    else:
        fn = loop.search_walk_plain if plain else search.search_walk
    return fn(*args, **kwargs)


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


def _check(case, card):
    kind, args, kwargs = case_args(case, card)
    before = search.launches
    got = run_search(kind, args, kwargs)
    torch.cuda.synchronize()
    assert search.launches == before + 1
    want = run_search(kind, args, kwargs, plain=True)
    assert not search_mismatches(got, want)
    assert not bool(got[2]["status"].any())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_search_matches_plain_on_card(card, name):
    got = _check(search_case(name, 256, 41), card)
    if name == "walk_cap":
        assert int((got[2]["evals"] == 42).sum()) > 200


@pytest.mark.cuda
@pytest.mark.parametrize("G", [512, 4096, 4099])
def test_search_matches_plain_at_widths(card, G):
    _check(search_case("stepsize", G, G), card)
    _check(search_case("walk", G, G + 1), card)


@pytest.mark.cuda
def test_loop_searches_launch_k3_not_bits_at(card):
    kind, args, kwargs = case_args(search_case("stepsize", 64, 5), card)
    before = (search.launches, K.bits_at.launches)
    qss, bits, c = loop.search_stepsize(*args)
    loop.search_walk(args[0], args[1], qss, *args[3:])
    assert (search.launches, K.bits_at.launches) == (before[0] + 2,
                                                     before[1])
    assert bits is c["bits"]


@pytest.mark.cuda
def test_search_of_no_granule_launches_nothing(card):
    kind, args, kwargs = case_args(search_case("walk", 0, 6), card)
    before = search.launches
    qss, bits, c = search.search_walk(*args)
    assert search.launches == before
    assert qss.shape == bits.shape == c["evals"].shape == (0,)
