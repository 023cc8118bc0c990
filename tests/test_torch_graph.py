"""The rate loop as CUDA graphs, checked on the CPU (``ops/loop.py``).

``outer_loop`` is a prologue, an iteration body and an epilogue over one
state; on a CUDA tensor the first two are captured once per key and
replayed.  A capture records kernels, so what these tests hold is what a
capture needs of the Python: the prologue and one iteration read no
device value on the host, build no tensor from host data and copy
nothing between devices (an aten-op log, on the CPU and on the meta
device); the iteration updates every state tensor in place; the host
side of the captured loop (``_run_loop``: ``graphs.run`` of the
prologue, ``graphs.run_next`` of the iterations) with a stand-in for the
capture gives ``outer_loop_eager``'s outputs exactly, call after call on
one key, and those hold to ``jaxloop.outer_loop`` as
tests/test_torch_loop.py does; the cache keeps at most its size and
keeps alive what its graphs read.  The graphs themselves are checked on
the card (tests/test_torch_graph_card.py, chip_smoke.py phase 5b).
"""
import gc
import json
import sys
import weakref
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from mp3tpu.ops import jaxloop
from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import graphs as G
from mp3tpu_torch.ops import loop, search
from mp3tpu_torch.tools import trace_stages
from test_torch_loop import _graft_example, _match_share, _mixed_blocks_example

torch.set_num_threads(1)

#: ops that read a device value on the host (a sync, refused in a capture)
HOST_READS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
              "aten.is_nonzero"}
#: ops that make a tensor from host data (on the card: an upload)
HOST_DATA = {"aten.lift_fresh", "aten.lift_fresh_copy", "aten.lift"}


def _scfsi_example():
    """The mixed-blocks batch with scfsi masks, fixed values and a warm
    lower bound (``encode_final``'s arguments on MPEG-1)."""
    d = _mixed_blocks_example()
    G = len(d["block_type"])
    rng = np.random.RandomState(11)
    mask = rng.rand(G, 21) < 0.35
    d.update(sf_fix_mask=mask,
             sf_fix_val=rng.randint(0, 3, (G, 21)).astype(np.int8),
             sf_skip_mask=mask & (np.arange(G) % 2 == 1)[:, None],
             qss_lo=rng.randint(-90, -40, G).astype(np.float32))
    return d


#: (id, example, MPEG version) of the loop's cases
CASES = (("graft_entry_g16", _graft_example, mpeg.MPEG1),
         ("short_start_stop", _mixed_blocks_example, mpeg.MPEG1),
         ("scfsi_masks", _scfsi_example, mpeg.MPEG1),
         ("lsf_22k", _mixed_blocks_example, mpeg.MPEG2_LSF))
SAFETY_CASES = [c for c in CASES if c[0] != "short_start_stop"]


def _inputs(d, device="cpu"):
    """``loop._inputs`` of an example dict on `device`."""
    def t(k):
        return None if d.get(k) is None else torch.tensor(d[k]).to(device)
    bt = d["block_type"]
    return loop._inputs(t("xr"), t("budget"), t("ratio_l"), t("ratio_s"),
                        torch.tensor(bt != mpeg.NORM_TYPE).to(device),
                        torch.tensor(bt).to(device), t("sf_fix_mask"),
                        t("sf_fix_val"), t("sf_skip_mask"), t("qss_lo"))


def _tables(version, device="cpu"):
    return loop.device_tables(loop.static_tables(version, 0), device)


class OpLog(TorchDispatchMode):
    """Every aten op run inside, with the devices of its tensors."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        devices = {t.device.type for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)}
        self.ops.append((str(func.overloadpacket), devices))
        return out


def _recorded_searches(monkeypatch, inputs, ST):
    """The plain searches' results of one prologue and one iteration on
    these inputs: (stepsize result, walk result)."""
    got = {}

    def keep(name, fn):
        def run(*args, **kwargs):
            got[name] = fn(*args, **kwargs)
            return got[name]
        return run

    with monkeypatch.context() as m:
        m.setattr(loop, "search_stepsize",
                  keep("stepsize", loop.search_stepsize))
        m.setattr(loop, "search_walk", keep("walk", loop.search_walk))
        state, best = loop._prologue(ST=ST, **inputs)
        loop._iteration(state, best, ST)
    return got["stepsize"], got["walk"]


def _moved(res, device):
    return tuple({k: v.to(device) for k, v in r.items()} if isinstance(
        r, dict) else r.to(device) for r in res)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name,example,version", SAFETY_CASES,
                         ids=[c[0] for c in SAFETY_CASES])
def test_prologue_and_iteration_are_capture_safe(monkeypatch, name, example,
                                                 version, device):
    """The prologue and one iteration, their searches replaced by stubs
    that return the plain searches' results, under an aten-op log: no
    host read of a device value, no tensor from host data, every tensor
    of every op on the run's device (on "meta", a device whose values
    the host cannot read, as on the card)."""
    d = example()
    cpu_inputs, cpu_ST = _inputs(d), _tables(version)
    stepsize, walk = _recorded_searches(monkeypatch, cpu_inputs, cpu_ST)
    inputs, ST = _inputs(d, device), _tables(version, device)
    stepsize, walk = _moved(stepsize, device), _moved(walk, device)
    monkeypatch.setattr(loop, "search_stepsize", lambda *a, **k: stepsize)
    monkeypatch.setattr(loop, "search_walk", lambda *a, **k: walk)
    with OpLog() as log:
        state, best = loop._prologue(ST=ST, **inputs)
        loop._iteration(state, best, ST)
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 200
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device.type == device
               for t in tree_leaves((state, best)) if t is not None)


def test_iteration_updates_the_state_in_place():
    """Each tensor an iteration writes stays the same tensor (a graph
    writes into the memory it captured); no two of the prologue's tensors
    share storage (the pass-through inputs budget and is_short_block
    aside)."""
    d = _scfsi_example()
    ST = _tables(mpeg.MPEG1)
    inputs = _inputs(d)
    state, best = loop._prologue(ST=ST, **inputs)
    made = {f"state.{k}": v for k, v in state.items()
            if v is not None and k not in ("budget", "is_short_block")}
    made.update({f"best.{k}": v for k, v in best.items()})
    storages = {v.untyped_storage().data_ptr() for v in made.values()}
    assert len(storages) == len(made)

    def written():
        out = {k: state[k] for k in loop.LOOP_STATE}
        out.update({f"best.{k}": v for k, v in best.items()})
        return out

    tensors = written()
    before = {k: v.clone() for k, v in tensors.items()}
    for _ in range(3):
        loop._iteration(state, best, ST)
        assert all(v is tensors[k] for k, v in written().items())
    assert any(not torch.equal(before[k], v) for k, v in tensors.items())
    assert state["budget"] is inputs["budget"]


def _caller():
    """The name of the function that called the caller."""
    return sys._getframe(2).f_code.co_name


def _stand_in(fn):
    """A capture that records nothing: its replay runs fn eagerly."""
    return SimpleNamespace(replay=fn)


def _perturbed(d):
    """Another batch of d's key: the spectrum rolled, budgets cut."""
    e = dict(d)
    e["xr"] = np.roll(d["xr"], 3, axis=0)
    e["budget"] = (d["budget"] * 0.7).astype(np.float32)
    return e


@pytest.fixture
def graphs(monkeypatch):
    """An empty graph cache of its own, and zeroed graph counts."""
    cache = G.GraphCache(loop.GRAPH_CACHE_SIZE)
    monkeypatch.setattr(loop, "GRAPHS", cache)
    monkeypatch.setattr(G, "graph_counts", {
        s: dict(captures=0, replays=0) for s in G.STAGES})
    return cache


def _run(inputs, ST):
    """``_run_loop`` with the stand-in capture, to outer_loop's
    outputs."""
    entry, _, _ = loop._run_loop(inputs, ST, 6, _stand_in)
    pro = entry.outputs["prologue"]
    best = {k: v.clone() for k, v in pro["best"].items()}
    return loop._epilogue(inputs["xr"], best, pro["state"]["qss0"].clone(),
                          inputs["block_type"], inputs["is_short_block"])


@pytest.mark.parametrize("name,example,version", CASES,
                         ids=[c[0] for c in CASES])
def test_captured_loop_equals_eager_and_jax(graphs, name, example, version,
                                            monkeypatch):
    """Three calls on one key (the warm-up and capture, then two of
    replays, the second with other inputs): every output equals
    ``outer_loop_eager``'s exactly, with as many iterations counted (on
    the device sum), though the captured loop runs all ``max_iter``
    iterations and reads no exit on the host; the first call holds to
    ``jaxloop.outer_loop`` as tests/test_torch_loop.py holds the loop
    (identical integer outputs on at least 95% of granules, each within
    its budget)."""
    ST = _tables(version)
    d = example()
    exits = []
    real_any = loop.any_on_host

    def any_on_host(mask):
        # the loop's own exit reads (the plain searches' walks aside)
        if _caller() in ("_eager", "_run_loop", "iterate", "_iterations",
                         "run", "run_next"):
            exits.append(_caller())
        return real_any(mask)

    any_on_host.syncs = 0          # what real_any counts in, meanwhile
    monkeypatch.setattr(loop, "any_on_host", any_on_host)
    acc = loop.iterations_on("cpu")
    outs = []
    for batch in (d, _perturbed(d), d):
        inputs = _inputs(batch)
        i0 = int(acc)
        got = _run(inputs, ST)
        i1 = int(acc)
        assert not exits
        ref = loop.outer_loop_eager(ST=ST, max_iter=6, **inputs)
        assert 0 < int(acc) - i1 == i1 - i0 <= 6 and exits
        exits.clear()
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        outs.append(got)
    assert len(graphs) == 1 and G.totals()["captures"] == 2
    assert G.by_stage()["prologue"] == (1, 2)
    assert G.by_stage()["iteration"] == (1, 2)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[2][k]), k

    STj = jaxloop._static(version, 0)
    bt = d["block_type"]
    masks = {k: jnp.asarray(d[k]) for k in
             ("sf_fix_mask", "sf_fix_val", "sf_skip_mask", "qss_lo")
             if d.get(k) is not None}
    ref = jaxloop.outer_loop(jnp.asarray(d["xr"]), jnp.asarray(d["budget"]),
                             jnp.asarray(d["ratio_l"]),
                             jnp.asarray(d["ratio_s"]),
                             jnp.asarray(bt != mpeg.NORM_TYPE),
                             jnp.asarray(bt), STj, **masks)
    share = _match_share(ref, outs[0], len(bt))
    assert share >= 0.95, share
    assert (outs[0]["part2_3_length"].numpy() <= d["budget"]).all()


def test_outer_loop_on_the_cpu_is_the_eager_loop(graphs):
    d = _mixed_blocks_example()
    ST = _tables(mpeg.MPEG1)
    inputs = _inputs(d)
    got = loop.outer_loop(ST=ST, **inputs)
    ref = loop.outer_loop_eager(ST=ST, **inputs)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert len(graphs) == 0 and G.totals() == dict(captures=0, replays=0)


def test_cache_keeps_its_size_least_recent_first():
    cache = G.GraphCache(3)
    for k in "abcd":
        dropped = cache.put(k, k.upper())
    assert dropped == ["A"] and len(cache) == 3
    assert cache.get("b") == "B" and cache.get("a") is None
    assert cache.put("e", "E") == ["C"]          # b was used since
    assert list(cache.entries) == ["d", "b", "e"]
    cache.clear()
    assert len(cache) == 0


def _small_batch(G, seed):
    rng = np.random.RandomState(seed)
    bt = rng.choice([0, 0, 1, 2, 3], G).astype(np.int32)
    return dict(xr=(rng.randn(G, 576) * 0.05).astype(np.float32),
                budget=rng.choice([300.0, 1200.0, 4095.0], G)
                .astype(np.float32),
                ratio_l=np.full((G, 21), 0.02, np.float32),
                ratio_s=np.full((G, 12, 3), 0.02, np.float32),
                block_type=bt)


def test_cache_holds_what_its_graphs_read(monkeypatch, graphs):
    """An entry keeps the rate's tables and its state alive after the
    caller dropped them, and lets them go when the cache drops it."""
    monkeypatch.setattr(loop, "GRAPHS", G.GraphCache(2))
    # tables of their own (device_tables would share the process's)
    ST = loop._device_tables(loop.static_tables(mpeg.MPEG1, 1), "cpu")
    table = weakref.ref(ST["oh_l"])
    entry, _, _ = loop._run_loop(_inputs(_small_batch(8, 0)), ST, 6,
                                 _stand_in)
    state = weakref.ref(entry.outputs["prologue"]["state"]["xr75p"])
    assert entry.refs[0]["oh_l"] is ST["oh_l"]
    del ST, entry
    gc.collect()
    assert table() is not None and state() is not None
    ST2 = _tables(mpeg.MPEG1)
    for n in (12, 16):
        loop._run_loop(_inputs(_small_batch(n, 1)), ST2, 6, _stand_in)
    gc.collect()
    assert len(loop.GRAPHS) == 2
    assert table() is None and state() is None


def test_key_is_the_tables_tensors_and_the_inputs_layout():
    d = _scfsi_example()
    inputs = _inputs(d)
    ST = _tables(mpeg.MPEG1)
    key = G.key_of(inputs, ST)
    # another dict of the same tensors (Layer3SegmentEncoder.tables makes
    # one a call), and equal tables made again, are the same key
    assert G.key_of(inputs, dict(ST)) == key
    assert G.key_of(inputs, _tables(mpeg.MPEG1)) == key
    assert G.key_of(_inputs(_perturbed(d)), ST) == key
    other = loop._device_tables(loop.static_tables(mpeg.MPEG1, 0), "cpu")
    assert G.key_of(inputs, other) != key
    assert G.key_of(dict(inputs, qss_lo=None), ST) != key
    assert G.key_of(_inputs(_small_batch(8, 0)), ST) != key


def test_equal_tables_are_one_set_of_tensors():
    a = _tables(mpeg.MPEG1)
    b = loop.device_tables(dict(loop.static_tables(mpeg.MPEG1, 0)), "cpu")
    c = _tables(mpeg.MPEG2_LSF)
    assert a is not b and a.keys() == b.keys()
    assert all(a[k] is b[k] for k in a)
    assert a["oh_l"] is not c["oh_l"]


def test_replays_count_the_launches_their_graph_holds(monkeypatch):
    """A capture takes the launches made into it back out of the
    wrappers' counts; each replay adds them again."""
    monkeypatch.setattr(G, "graph_counts", {
        s: dict(captures=0, replays=0) for s in G.STAGES})
    monkeypatch.setattr(search, "launches", 10)

    def launch_twice():
        search.launches += 2

    def record(fn):
        fn()                              # a capture makes the calls
        return SimpleNamespace(replay=lambda: None)

    entry = G.Captured({}, ())
    entry.capture("iteration", launch_twice, record, "iteration")
    assert search.launches == 10
    assert entry.held["iteration"] == [2, 0, 0, 0, 0]
    for n in (1, 2):
        entry.replay("iteration")
        assert search.launches == 10 + 2 * n
    assert G.totals() == dict(captures=1, replays=2)
    assert G.by_stage()["iteration"] == (1, 2)


def test_span_breakdown_counts_dispatches_and_graph_kernels(tmp_path):
    """A hand-made trace: a rate loop whose kernels come from one eager
    launch and one graph launch, a copy, calls that dispatch nothing,
    and a launch outside every span."""
    def x(cat, name, ts, corr=None):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=1,
                    args={} if corr is None else {"correlation": corr})
    events = [dict(x("user_annotation", "outer_loop", 0), dur=50),
              x("cuda_runtime", "cudaLaunchKernel", 1, 1),
              x("cuda_runtime", "cudaGraphLaunch", 2, 2),
              x("cuda_runtime", "cudaMemcpyAsync", 3, 3),
              x("cuda_runtime", "cudaStreamSynchronize", 4),
              x("cuda_runtime", "cudaStreamWaitEvent", 5),
              x(trace_stages.LAUNCH_CATS[1], "cuLaunchKernel", 60, 4),
              x("kernel", "where", 10, 1),
              x("kernel", "(anonymous namespace)::search_kernel(float4)",
                11, 2),
              x("kernel", "where", 12, 2),
              x("gpu_memcpy", "Memcpy DtoH", 13, 3),
              x("kernel", "after", 61, 4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    bd = trace_stages.span_breakdown(str(path))
    rec = bd["spans"]["outer_loop"]
    assert (rec["host_dispatches"], rec["self_host_dispatches"]) == (3, 3)
    assert rec["device_events"] == 4 and bd["unlinked_events"] == 0
    assert (bd["host_dispatches"], bd["graph_launches"]) == (4, 1)
    assert bd["search_kernel_events"] == 1
