"""A granule-level numpy model of K3 (csrc/bits_at.cu search_kernel)
against the lockstep plain searches, and both against the JAX package.

The kernel runs each granule's search in its own loop (one warp, its own
exit) where the plain searches (loop.search_stepsize_plain and
search_walk_plain, the JAX package's loops) step the whole batch until
its slowest granule fits.  The model follows the kernel granule by
granule: the same phases and caps, the stepsize's factor read from the
integer table the wrapper builds with torch's exp2 (every stepsize it
meets is checked to be an integer in [-512, 511], the status rule), and
each evaluation bits_at_plain on that one granule.  It must equal the
lockstep search exactly on qss, bits, every count row and each granule's
evaluation count.

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
from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop, search
from test_torch_search_card import (CASES, case_args, run_search,
                                    search_case, search_mismatches)

torch.set_num_threads(1)

G = 128
SEED = 3
TABLE = search._istep_table(torch.device("cpu"))
COUNT_KEYS = ("count1", "big_values", "r0", "r1", "a1", "a2",
              "table_select", "count1table_select", "ix_max")


def on_table(q):
    """The status rule: an integer stepsize in the table's range."""
    q = np.asarray(q, np.float32)
    return bool(np.all((q == np.floor(q)) & (q >= search.STEP_LO)
                       & (q <= search.STEP_HI)))


def table_quantize(xr75, qss):
    """loop.quantize_pow75 with K3's factor: the table entry of qss."""
    assert on_table(qss.numpy()), qss
    istep75 = TABLE[(qss - search.STEP_LO).long()][:, None]
    return loop._to_ix(xr75 * istep75 - 0.0946 + 0.5)


def model_search(kind, args, kwargs, n_bisect=8, max_steps=40):
    """Each granule's search as one warp of search_kernel runs it.
    Returns dict(qss, bits, c: the counts with evals, status, met: every
    stepsize met, first_bits: each granule's bits at its first one)."""
    xr75p, budget, start, short, sblk, ST = args
    qss_lo = kwargs.get("qss_lo")
    f32 = np.float32
    out, met, first_bits = [], [], []
    for g in range(xr75p.shape[0]):
        evals = 0
        status = 0

        def at(q):
            nonlocal evals, status
            evals += 1
            met.append(q)
            status |= not on_table(q)
            c = K.bits_at_plain(xr75p[g:g + 1],
                                torch.tensor([q], dtype=torch.float32),
                                short[g:g + 1], sblk[g:g + 1], ST)
            if evals == 1:
                first_bits.append(float(c["bits"][0]))
            return c

        b = f32(budget[g])
        qss = f32(start[g])
        if kind == "stepsize":
            floor_q = max(qss, f32(loop.QMIN))
            lo = floor_q if qss_lo is None else max(floor_q, f32(qss_lo[g]))
            hi = f32(loop.QMAX)
            for _ in range(n_bisect):
                mid = f32(np.floor(f32(f32(lo + hi) * f32(0.5))))
                if at(mid)["bits"][0] <= b:
                    hi = mid
                else:
                    lo = mid
            qss = hi
        bits = at(qss)["bits"][0]
        steps = 0
        while steps < max_steps and bits > b:
            qss = f32(qss + f32(1.0))
            bits = at(qss)["bits"][0]
            steps += 1
        if kind == "stepsize":
            for _ in range(3):
                q2 = f32(qss - f32(1.0))
                b2 = at(q2)["bits"][0]
                if b2 <= b and q2 >= floor_q:
                    qss, bits = q2, b2
        c = at(qss)
        c["evals"] = torch.tensor([evals], dtype=torch.int32)
        out.append((qss, c, status))
    qss = torch.tensor([o[0] for o in out], dtype=torch.float32)
    c = {k: torch.cat([o[1][k] for o in out]) for k in out[0][1]}
    return dict(qss=qss, bits=c["bits"], c=c,
                status=np.array([o[2] for o in out]),
                met=np.array(met, np.float32),
                first_bits=np.array(first_bits))


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


_RESULTS = {}


def results(name):
    """Per case: the model and the plain search with the table's factor,
    the unpatched plain search, and JAX's."""
    if name not in _RESULTS:
        case = search_case(name, G, SEED)
        kind, version = case[:2]
        kind, args, kwargs = case_args(case, "cpu")
        with mock.patch.object(loop, "quantize_pow75", table_quantize):
            model = model_search(kind, args, kwargs)
            table_plain = run_search(kind, args, kwargs, plain=True)
        plain = run_search(kind, args, kwargs, plain=True)
        _RESULTS[name] = dict(model=model, table_plain=table_plain,
                              plain=plain,
                              jax=jax_search(kind, version, args, kwargs))
    return _RESULTS[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_model_equals_lockstep_plain(name):
    r = results(name)
    m = r["model"]
    assert not search_mismatches((m["qss"], m["bits"], m["c"]),
                                 r["table_plain"])
    assert not m["status"].any()
    # every stepsize the searches meet is an integer in the table
    assert on_table(m["met"]) and on_table(r["plain"][0].numpy())
    evals = m["c"]["evals"].numpy()
    # silent granules, and granules past IXMAX at their first stepsize
    assert (m["first_bits"] == 0).any() and (m["first_bits"] == 1e9).any()
    if name.startswith("stepsize"):
        assert evals.min() >= 13
    if name == "walk_cap":
        assert (evals == 42).sum() >= G - G // 7 - 1
        assert (r["plain"][1][evals == 42] > 0).all()


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
