"""The rate loop as CUDA graphs on the card: ``loop.outer_loop`` (its
prologue and its ``max_iter`` iterations, unrolled, captured on a key's
first call and replayed once each a call) against
``loop.outer_loop_eager`` (the same functions op by op, with the exit
read on the host), equal on every output and on the live iterations
counted, with no loop-exit sync and a K3 launch in every unrolled
iteration, the launches made inside graphs counted at each replay; and
a capture of a loop whose searches were swapped for the plain ones
(which read the device on the host) raises.

A CUDA graph has no CPU mode, so these tests carry the `cuda` marker and
skip without a card.  This file imports no jax; run it on the card
without the repository's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graph_card.py
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import graphs as G
from mp3tpu_torch.ops import loop, search
from mp3tpu_torch.tables import mpeg

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def graphs(monkeypatch, card):
    """An empty graph cache of its own, and zeroed graph counts."""
    cache = G.GraphCache(loop.GRAPH_CACHE_SIZE)
    monkeypatch.setattr(loop, "GRAPHS", cache)
    monkeypatch.setattr(G, "graph_counts", {
        s: dict(captures=0, replays=0) for s in G.STAGES})
    yield cache
    torch.cuda.synchronize()


def loop_batch(card, G, version, seed, final):
    """A random outer_loop batch on the card (`card`): (args, kwargs).
    Mixed long, short and start/stop granules, silent and band-limited
    ones, budgets from 0 to 4095 and random masking ratios; `final` adds
    what encode_final passes: a warm lower bound and, for MPEG-1, scfsi
    masks with their fixed values.  chip_smoke.py phase 5b uses it too."""
    rng = np.random.RandomState(seed)
    xr = rng.randn(G, 576) * rng.uniform(0.002, 0.2, (G, 1))
    xr[::7, 300:] = 0.0
    xr[5::97] = 0.0
    bt = rng.choice([0, 0, 0, 0, 0, 0, 1, 2, 3], G)
    ST = loop.device_tables(loop.static_tables(version, 0), card)

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=card)

    args = (dev(xr), dev(rng.choice([0.0, 300.0, 900.0, 1500.0, 4095.0], G)),
            dev(10.0 ** rng.uniform(-3, -0.5, (G, 21))),
            dev(10.0 ** rng.uniform(-3, -0.5, (G, 12, 3))),
            dev(bt != 0, bool), dev(bt, np.int32), ST)
    kwargs = {}
    if final:
        kwargs["qss_lo"] = dev(rng.randint(-120, -30, G))
        if version == mpeg.MPEG1:
            mask = rng.rand(G, 21) < 0.3
            kwargs.update(sf_fix_mask=dev(mask, bool),
                          sf_fix_val=dev(rng.randint(0, 4, (G, 21)), np.int8),
                          sf_skip_mask=dev(mask & (np.arange(G) % 2 == 1)
                                           [:, None], bool))
    return args, kwargs


def _counted(fn, *args, **kwargs):
    """fn's outputs and the K3 launches, loop-exit syncs, graph captures
    and replays and live iterations it made."""
    acc = loop.iterations_on(torch.device("cuda"))

    def now():
        return (search.launches, loop.any_on_host.syncs,
                G.totals()["captures"], G.totals()["replays"], int(acc))

    before = now()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(now(), before)]


def _assert_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["demand", "final"])
@pytest.mark.parametrize("version", [mpeg.MPEG1, mpeg.MPEG2_LSF],
                         ids=["mpeg1", "lsf"])
@pytest.mark.parametrize("G", [512, 4096])
def test_graphs_equal_eager_and_count_alike(graphs, card, G, version, final):
    """The first call (the warm-up runs all 6 iterations, then two
    captures), a second (both graphs replayed once) and a call on another
    batch of the key: each equal to outer_loop_eager on every output and
    on the live iterations counted on the device, with 1 + 6 K3 launches
    and no loop-exit sync where the eager loop reads its exit on the
    host once an iteration."""
    args, kwargs = loop_batch(card, G, version, G + final, final)
    other, other_kw = loop_batch(card, G, version, G + final + 7, final)
    ref, (k3, syncs, _, _, iterations) = _counted(loop.outer_loop_eager,
                                                  *args, **kwargs)
    assert k3 == 1 + iterations and syncs >= iterations > 0
    got, counts = _counted(loop.outer_loop, *args, **kwargs)
    _assert_equal(got, ref)
    assert counts == [7, 0, 2, 0, iterations]
    got, counts = _counted(loop.outer_loop, *args, **kwargs)
    _assert_equal(got, ref)
    assert counts == [7, 0, 0, 2, iterations]
    ref2, (_, _, _, _, iterations2) = _counted(loop.outer_loop_eager,
                                               *other, **other_kw)
    got2, counts = _counted(loop.outer_loop, *other, **other_kw)
    _assert_equal(got2, ref2)
    assert counts == [7, 0, 0, 2, iterations2]
    assert len(graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["demand", "final"])
@pytest.mark.parametrize("version", [mpeg.MPEG1, mpeg.MPEG2_LSF],
                         ids=["mpeg1", "lsf"])
@pytest.mark.parametrize("G", [512, 4096])
def test_unrolled_equals_the_stepwise_replay(graphs, card, G, version,
                                             final):
    """The unrolled graphs (one replay of the 6 iterations, no exit read)
    against the iteration replayed one at a time with the exit read on
    the host after each (``outer_loop_stepwise``), over a capture call
    and a replay call: equal on every output and on the live iterations;
    the stepwise form syncs at least once an iteration and launches K3
    once a live iteration, the unrolled form never syncs and launches it
    in all 6."""
    args, kwargs = loop_batch(card, G, version, G + final + 3, final)
    for _ in range(2):
        ref, (k3, syncs, _, _, iterations) = _counted(
            loop.outer_loop_stepwise, *args, **kwargs)
        got, counts = _counted(loop.outer_loop, *args, **kwargs)
        _assert_equal(got, ref)
        assert k3 == 1 + iterations and syncs >= iterations > 0
        assert (counts[0], counts[1], counts[4]) == (7, 0, iterations)
    assert len(graphs) == 2


@pytest.mark.cuda
def test_replayed_launches_are_the_kernels_that_ran(graphs, card):
    """search.launches equals the search_kernel events torch.profiler
    records over a call that captures and one that replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, kwargs = loop_batch(card, 4096, mpeg.MPEG1, 5, True)
    for _ in range(2):
        before = search.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loop.outer_loop(*args, **kwargs)
            torch.cuda.synchronize()
        events = sum("search_kernel(" in e.name for e in prof.events()
                     if getattr(e, "device_type", None) == DeviceType.CUDA)
        assert events == search.launches - before > 0


@pytest.mark.cuda
def test_capture_of_the_plain_searches_raises(graphs, card, monkeypatch):
    """The plain searches read their walks' exit on the host: a capture of
    them fails, and the error reaches the caller (no eager fall back).
    Last in the file: a failed capture may leave the loop stream's
    allocations routed to its pool for the rest of the process."""
    monkeypatch.setattr(loop, "search_stepsize", loop.search_stepsize_plain)
    monkeypatch.setattr(loop, "search_walk", loop.search_walk_plain)
    args, kwargs = loop_batch(card, 512, mpeg.MPEG1, 9, False)
    with pytest.raises(RuntimeError):
        loop.outer_loop(*args, **kwargs)
    assert len(graphs) == 0
