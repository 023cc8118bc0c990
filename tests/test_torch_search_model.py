"""A granule-level numpy model of K3 (csrc/bits_at.cu search_kernel)
against the lockstep plain searches, and both against the JAX package.

The kernel runs each granule's search on its own (its warps, its own
exit) where the plain searches (loop.search_stepsize_plain and
search_walk_plain, the JAX package's loops) step the whole batch until
its slowest granule fits.  The model (``model_search`` in
tests/test_torch_search_card.py, which runs on the card too) follows the
kernel granule by granule and pass by pass, at each width the kernel
takes: a granule's warps evaluate a bisection tree of 1, 2 or 3 levels,
a ladder of walk rungs or the down rungs at once; it never evaluates a
stepsize whose outcome it knows (the bisection's lo and hi, the walk's
last rung), keeps the accepted stepsize's rows instead of evaluating it
again, and ends the down steps at their first miss.  The stepsize's
factor is read from the integer table the wrapper builds with torch's
exp2 (every stepsize it meets is checked to be an integer in [-512,
511], the status rule), and each evaluation is bits_at_plain.  At every
width the model must equal the lockstep search exactly on qss, bits,
every count row and each granule's evaluation count (``evals``, the
plain search's); at width 1 the evaluations it runs (``runs``) must be
the distinct stepsizes whose outcome the plain search reads, and a wider
granule runs those and more in as many passes or fewer.

One caveat of the CPU only: torch's exp2 rounds a few factors one way in
its vectorized path and the other in its scalar tail, so the same
stepsize can get two factors at two lane positions of a CPU batch.  The
model and the lockstep search therefore both quantize with the table's
factor here (``table_quantize``), which is what the kernel does; on the
card torch's exp2 gives every lane the table's factor, and K3 is held to
the unpatched plain searches (tests/test_torch_search_card.py).  The
unpatched plain searches are held to the JAX package's on the same
float32 spectrum: equal on every granule, or on 99% where one library's
exp2 rounds to the other side (the mismatches are printed).  A granule
that both put past IXMAX (bits 1e9: a walk that met its cap) is equal
when every row but ix_max is, and ix_max is past IXMAX on both sides:
its value there, some 124,000 at a factor of 2^11.25, moves by one with
the last bit of the two libraries' factor.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mp3tpu.ops import jaxloop
from mp3tpu_torch.ops import loop
from test_torch_search_card import (CASES, F32, WIDTHS, batch_evaluations,
                                    case_args, model_search, on_table,
                                    run_search, search_case,
                                    search_mismatches, table_quantize)

torch.set_num_threads(1)

G = 128
SEED = 3
COUNT_KEYS = ("count1", "big_values", "r0", "r1", "a1", "a2",
              "table_select", "count1table_select", "ix_max")


def serial_reads(kind, at, b, start, qss_lo, n_bisect=8, max_steps=40):
    """The stepsizes whose outcome one granule's plain search reads, in
    its order, as the plain schedule runs them one by one (the schedule
    of K3's first design): every bisection mid, the walk's stepsizes,
    and each down step at or above the floor (below it the step is
    refused whatever its bits), then the accepted stepsize once more."""
    reads = []

    def bits(q):
        reads.append(q)
        return at(q)["bits"]

    qss = F32(start)
    floor_q = F32(-210.0)
    if kind == "stepsize":
        floor_q = max(qss, floor_q)
        lo = floor_q if qss_lo is None else max(floor_q, F32(qss_lo))
        hi = F32(45.0)
        for _ in range(n_bisect):
            mid = F32(np.floor(F32(F32(lo + hi) * F32(0.5))))
            if bits(mid) <= b:
                hi = mid
            else:
                lo = mid
        qss = hi
    b_q = bits(qss)
    steps = 0
    while steps < max_steps and b_q > b:
        qss = F32(qss + F32(1.0))
        b_q = bits(qss)
        steps += 1
    if kind == "stepsize":
        for _ in range(3):
            q2 = F32(qss - F32(1.0))
            if q2 >= floor_q and bits(q2) <= b:
                qss = q2
    reads.append(qss)
    return reads


_RESULTS = {}


def results(name):
    """Per case: the model at every width and the plain search with the
    table's factor, the stepsizes the plain schedule reads, the unpatched
    plain search, and JAX's."""
    if name not in _RESULTS:
        case = search_case(name, G, SEED)
        kind, version = case[:2]
        kind, args, kwargs = case_args(case, "cpu")
        at = batch_evaluations(args)
        models = {w: model_search(kind, args, kwargs, w, at=at)
                  for w in WIDTHS}
        budget, start = args[1].numpy(), args[2].numpy()
        lo = kwargs.get("qss_lo")
        reads = [serial_reads(kind, lambda q, g=g: at(g, q), budget[g],
                              start[g], None if lo is None else lo[g].item())
                 for g in range(G)]
        with mock.patch.object(loop, "quantize_pow75", table_quantize):
            table_plain = run_search(kind, args, kwargs, plain=True)
        plain = run_search(kind, args, kwargs, plain=True)
        first_bits = np.array([at(g, reads[g][0])["bits"]
                               for g in range(G)])
        _RESULTS[name] = dict(models=models, model=models[1], reads=reads,
                              at=at, args=(kind, args, kwargs),
                              first_bits=first_bits,
                              table_plain=table_plain, plain=plain,
                              jax=jax_search(kind, version, args, kwargs))
    return _RESULTS[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_model_equals_lockstep_plain(name):
    r = results(name)
    m = r["model"]
    assert not search_mismatches((m["qss"], m["bits"], m["c"]),
                                 r["table_plain"])
    # every stepsize the searches meet is an integer in the table
    met = [q for g in m["met"] for q in g]
    assert on_table(met) and on_table(r["plain"][0].numpy())
    evals = m["c"]["evals"].numpy()
    # silent granules, and granules past IXMAX at their first stepsize
    assert (r["first_bits"] == 0).any() and (r["first_bits"] == 1e9).any()
    if name.startswith("stepsize"):
        assert evals.min() >= 13
        # some granule fits at no bisection mid (hi = QMAX unevaluated)
        assert not all(m["mid_fit"])
    if name == "walk_cap":
        assert (evals == 42).sum() >= G - G // 7 - 1
        assert (r["plain"][1][evals == 42] > 0).all()
    if name == "stepsize_cap":
        assert (evals == 53).sum() >= G - G // 7 - 1
        assert (r["plain"][1][evals == 53] > 0).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_model_at_width_equals_lockstep_plain(name, width):
    """K3's schedule at `width` warps a granule: the lockstep search's
    results and evaluation counts; at width 1 it runs each stepsize whose
    outcome the plain search reads once, and no other; a wider granule
    runs a superset of those in as many passes or fewer, its bisection in
    ceil(8 / levels) rounds."""
    r = results(name)
    m = r["models"][width]
    assert not search_mismatches((m["qss"], m["bits"], m["c"]),
                                 r["table_plain"])
    runs = m["c"]["runs"].numpy()
    evals = m["c"]["evals"].numpy()
    one = r["models"][1]
    levels = (width + 1).bit_length() - 1
    for g in range(G):
        met = m["met"][g]
        assert len(met) == runs[g]
        assert set(one["met"][g]) <= set(met)
        assert m["passes"][g] <= one["passes"][g]
        if name.startswith("stepsize"):
            assert m["bisect_passes"][g] == -(-8 // levels)
    if width == 1:
        # each read stepsize once; the accepted one is never run again
        assert [sorted(x) for x in one["met"]] == \
            [sorted(set(x)) for x in r["reads"]]
        assert (runs < evals).all()
    else:
        assert (runs >= one["c"]["runs"].numpy()).all()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_bound_replay_equals_model_at_width_1(name):
    """chip_smoke.py's serial_work, the width-1 schedule replayed over the
    batch that K3's operations bound counts, runs the model's stepsizes at
    width 1: the same qss and runs, and the same big_values lines and
    count1 quads summed over them."""
    from chip_smoke import serial_work
    r = results(name)
    one, at = r["models"][1], r["at"]
    with mock.patch.object(loop, "quantize_pow75", table_quantize):
        work = serial_work(*r["args"])
    assert torch.equal(work["qss"], one["qss"])
    assert torch.equal(work["runs"].int(), one["c"]["runs"])
    for key, row, scale in (("pair_lines", "big_values", 2),
                            ("quads", "count1", 1)):
        want = [sum(scale * int(at(g, q)[row][0]) for q in met)
                for g, met in enumerate(one["met"])]
        assert work[key].tolist() == want, key


def jax_search(kind, version, args, kwargs):
    """jaxloop's search on the same float32 arrays."""
    STj = jaxloop._static(version, 0)
    xr75p, budget, start, short, sblk, _ = (
        jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
        for a in args)
    if kind == "stepsize":
        lo = kwargs.get("qss_lo")
        lo = None if lo is None else jnp.asarray(lo.numpy())
        fn = jax.jit(lambda x, b, q, s, w, lo: jaxloop.search_stepsize(
            x, b, q, s, w, STj, qss_lo=lo))
        return fn(xr75p, budget, start, short, sblk, lo)
    fn = jax.jit(lambda x, b, q, s, w: jaxloop.search_walk(x, b, q, s, w,
                                                           STj))
    return fn(xr75p, budget, start, short, sblk)


def _agreement(name, got, ref):
    """The share of granules whose qss, bits and counts are equal (ix_max
    past IXMAX on both sides where both give 1e9 bits); prints the
    others and the ix_max past IXMAX that differ."""
    qss, bits, c = got
    same = (np.asarray(ref[0]) == qss.numpy()) \
        & (np.asarray(ref[1]) == bits.numpy())
    out = (np.asarray(ref[1]) == 1e9) & (bits.numpy() == 1e9)
    for k in COUNT_KEYS:
        a = np.asarray(ref[2][k], np.int64).reshape(len(qss), -1)
        b = c[k].numpy().astype(np.int64).reshape(len(qss), -1)
        eq = (a == b).all(axis=1)
        if k == "ix_max":
            past = (a[:, 0] > loop.IXMAX) & (b[:, 0] > loop.IXMAX) & out
            for g in np.where(past & ~eq)[0]:
                print(f"{name} granule {g}: ix_max past IXMAX jax/torch "
                      f"{a[g, 0]} / {b[g, 0]}")
            eq |= past
        same &= eq
    for g in np.where(~same)[0]:
        print(f"{name} granule {g}: qss jax/torch {float(ref[0][g])} / "
              f"{float(qss[g])}, bits {float(ref[1][g])} / {float(bits[g])}")
    return same.mean()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_plain_and_model_equal_jax(name):
    r = results(name)
    share_plain = _agreement(f"{name} plain", r["plain"], r["jax"])
    m = r["model"]
    share_model = _agreement(f"{name} model", (m["qss"], m["bits"], m["c"]),
                             r["jax"])
    assert share_plain >= 0.99 and share_model >= 0.99
    # the unpatched plain search and the table's differ only by a flip
    assert _agreement(f"{name} plain vs table", r["plain"],
                      tuple(t.numpy() if isinstance(t, torch.Tensor) else
                            {k: v.numpy() for k, v in t.items()}
                            for t in r["table_plain"])) >= 0.99
