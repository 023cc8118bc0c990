"""The rate loop with its exit on the card, checked on the CPU
(``ops/loop.py``).

On a CUDA tensor ``outer_loop`` replays its prologue and ``max_iter``
iterations unrolled (``loop._iterations``), with no exit read on the
host; ``outer_loop_eager`` stops where ``jaxloop``'s ``iter_cond`` stops,
reading the exit on the host.  Here the unrolled form runs op by op on
the CPU -- the prologue, every one of the ``max_iter`` iterations, the
epilogue -- and equals the eager loop on every output of ``outer_loop``
and of the final encode's emission (``Layer3SegmentEncoder._emission``),
with the same live iterations counted (``state["iters"]``, summed by
``loop.iterations_on``).  The cases cover lanes finishing at different
iterations, every lane done before ``max_iter`` (once after the first
iteration, once after the fifth), lanes in the budget-fill mode, scfsi
masks with a warm lower bound, and LSF.  The graphs themselves run on
the card (tests/test_torch_graph_card.py, chip_smoke.py phase 5b).
"""
import numpy as np
import pytest
import torch

from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import loop
from test_torch_emission_graph import CAP, final_case  # noqa: F401
from test_torch_graph import _inputs, _scfsi_example, _tables
from test_torch_loop import _graft_example, _mixed_blocks_example

torch.set_num_threads(1)

MAX_ITER = 6


def _early_example():
    """The mixed blocks with every band's masking at its energy and no
    budget limit: every lane is done after the first iteration."""
    d = _mixed_blocks_example()
    d.update(ratio_l=np.ones_like(d["ratio_l"]),
             ratio_s=np.ones_like(d["ratio_s"]),
             budget=np.full_like(d["budget"], 4095.0))
    return d


def _fill_example():
    """Long blocks at budgets of 300-3000 bits and low masking ratios:
    budget-limited lanes, many of them in the fill mode."""
    rng = np.random.RandomState(3)
    G = 32
    return dict(
        xr=(rng.randn(G, 576) * rng.uniform(0.01, 0.3, (G, 1)))
        .astype(np.float32),
        budget=rng.uniform(300, 3000, G).astype(np.float32).round(),
        ratio_l=(10 ** rng.uniform(-4, -1, (G, 21))).astype(np.float32),
        ratio_s=(10 ** rng.uniform(-4, -1, (G, 12, 3))).astype(np.float32),
        block_type=np.zeros(G, np.int32))


#: (id, example, MPEG version, (fewest distinct finishing iterations,
#: live iterations or None for "all 6", fewest lanes that fill))
CASES = (("graft_entry_g16", _graft_example, mpeg.MPEG1, (3, 6, 1)),
         ("mixed_blocks", _mixed_blocks_example, mpeg.MPEG1, (4, 6, 1)),
         ("scfsi_masks", _scfsi_example, mpeg.MPEG1, (4, 6, 1)),
         ("mixed_blocks_lsf", _mixed_blocks_example, mpeg.MPEG2_LSF,
          (5, 5, 1)),
         ("all_done_at_1", _early_example, mpeg.MPEG1, (1, 1, 0)),
         ("budget_fill", _fill_example, mpeg.MPEG1, (5, 6, 10)))


def _unrolled(inputs, ST):
    """outer_loop as its graphs run it, op by op: (outputs, state)."""
    state, best = loop._prologue(ST=ST, **inputs)
    loop._iterations(state, best, ST, MAX_ITER)
    return loop._epilogue(inputs["xr"], best, state["qss0"],
                          inputs["block_type"],
                          inputs["is_short_block"]), state


def _finishing(inputs, ST):
    """Each lane's iteration of finishing in the eager loop (0: never
    within MAX_ITER) and the lanes that entered the fill mode."""
    state, best = loop._prologue(ST=ST, **inputs)
    at = torch.zeros_like(state["done"], dtype=torch.int64)
    filled = torch.zeros_like(state["done"])
    it = 0
    while it < MAX_ITER and loop.any_on_host(~state["done"]):
        loop._iteration(state, best, ST)
        it += 1
        at = torch.where(state["done"] & (at == 0), it, at)
        filled |= state["filling"]
    return at, filled, it


@pytest.mark.parametrize("name,example,version,cover", CASES,
                         ids=[c[0] for c in CASES])
def test_unrolled_loop_equals_eager(name, example, version, cover):
    """Every output of ``max_iter`` iterations with no exit equals the
    eager loop's, and so do the live iterations counted; the case covers
    what it claims to (finishing iterations, early exits, fill lanes)."""
    ST = _tables(version)
    inputs = _inputs(example())
    acc = loop.iterations_on("cpu")
    before = int(acc)
    ref = loop._eager(inputs, ST, MAX_ITER)
    live = int(acc) - before
    got, state = _unrolled(inputs, ST)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert int(state["iters"]) == live

    at, filled, it = _finishing(inputs, ST)
    distinct, want_live, fill = cover
    assert it == live == want_live
    assert len(set(at.tolist())) >= distinct
    assert int(filled.sum()) >= fill
    if live < MAX_ITER:
        assert bool(state["done"].all())


def test_unrolled_emission_equals_eager(final_case):  # noqa: F811
    """The final encode's emission and packing of the unrolled loop's
    outputs equal those of the eager loop (``Then`` continuation, op by
    op), rows and compacted, MPEG-1 with scfsi masks and LSF."""
    version, enc, args = final_case
    ST = enc.tables("st")
    inputs = enc._final_args(**args)
    out, _ = _unrolled(inputs, ST)
    for cap in (None, CAP):
        ref = loop._eager(inputs, ST, MAX_ITER, then=enc._then(96, cap))
        got = enc._emission(out, inputs, 96, cap)
        assert got.keys() == ref.keys() == {"side", "payload"}
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
