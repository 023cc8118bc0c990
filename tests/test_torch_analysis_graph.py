"""The segment program's analysis in one batch of lanes and as a CUDA
graph, checked on the CPU (``models/layer3.py``, ``ops/graphs.py``).

``Layer3SegmentEncoder._analysis`` runs psy, filterbank, MDCT, the NaN
guard and the scfsi flags of every lane of a segment in one batch; on a
CUDA tensor ``analysis`` replays it as one captured graph.  These tests
hold the batched analysis equal to the per-lane yardstick
(``analysis_eager``, what the CPU runs) at 1, 2 and 4 lanes, MPEG-1 and
LSF, with mixed automaton states, and to the JAX package's
``analyze_demand_fused``; check that it can be captured (an aten-op log
on "cpu" and "meta": no host read, no tensor from host data, no op
across devices); run the captured host side (``graphs.run``) with a
stand-in capture against the yardstick call after call, with its
results written into static tensors that the next replay's temporaries
never are; and check that equal tables on one device are one set of
tensors.  The graphs themselves are checked on the card
(tests/test_torch_analysis_graph_card.py, chip_smoke.py phase 5c).
"""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from mp3tpu.models import layer3 as jlayer3
from mp3tpu_torch.models import layer3
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import bits, dsp, graphs, lanes, loop, psy
from mp3tpu_torch.runtime.wav import read_wav
from mp3tpu_torch.tables import mpeg
from test_torch_graph import HOST_DATA, HOST_READS, OpLog

torch.set_num_threads(1)

#: (version, sampling_frequency) of the cases: MPEG-1 44.1 kHz, LSF 22.05
VERSIONS = {"mpeg1": (mpeg.MPEG1, 0), "lsf": (mpeg.MPEG2_LSF, 0)}
#: the lanes' (fixture, channel, granule) and automaton states
LANES = (("trans_st_128", 0, 36, 0), ("trans_st_128", 1, 36, 2),
         ("q_mix_st_128", 0, 20, 3), ("q_mix_st_128", 1, 52, 0))


def segment(golden_dir, L, S, lanes_=LANES):
    """blocks_h4 (L, 4 + S, 576) int16 and fsm_init (L,) int32 of the
    first L of `lanes_`: each lane S granules of a fixture's channel with
    the 4 blocks before them, as the encoder slices a segment."""
    blocks, fsm = [], []
    for name, ch, pos, state in lanes_[:L]:
        pcm, _ = read_wav(os.path.join(golden_dir, f"{name}.wav"))
        x = np.asarray(pcm)[:, ch].astype(np.int16)
        G = -(-len(x) // 576)
        x = np.pad(x, (0, G * 576 - len(x))).reshape(G, 576)
        bl = np.zeros((4 + S, 576), np.int16)
        n = min(S, G - pos)
        bl[:4] = x[pos - 4:pos]
        bl[4:4 + n] = x[pos:pos + n]
        blocks.append(bl)
        fsm.append(state)
    return torch.tensor(np.stack(blocks)), torch.tensor(fsm, dtype=torch.int32)


def _assert_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("L", [1, 2, 4])
def test_batched_analysis_equals_per_lane(golden_dir, L, version):
    """One batch of L lanes == lane by lane, every output bit for bit
    (the products of ``lanes.PER_LANE`` one a lane)."""
    enc = Layer3SegmentEncoder(*VERSIONS[version], "cpu")
    blocks, fsm = segment(golden_dir, L, 64)
    got = enc._analysis(blocks, fsm)
    _assert_equal(got, enc.analysis_eager(blocks, fsm))
    assert got["xr"].shape == (L * 64, 576)
    assert ("scfsi" in got) == (version == "mpeg1")
    # the lanes carry transients: both block switching and the carried
    # automaton states take part
    assert (got["block_type"] == 2).any() and (got["block_type"] != 0).any()
    assert enc.analysis(blocks, fsm).keys() == got.keys()


@pytest.mark.parametrize("version", VERSIONS)
def test_batched_analysis_holds_to_jax(golden_dir, version):
    """The batched analysis of a stereo segment against the JAX package's
    ``analyze_demand_fused``, as tests/test_torch_layer3.py and
    tests/test_torch_dsp_psy.py hold the per-lane one: block types and
    the automaton's carry exact, the spectrum within 1e-5 of its peak,
    the scfsi flags on at least 90% of the bands."""
    v, sf = VERSIONS[version]
    enc = Layer3SegmentEncoder(v, sf, "cpu")
    blocks, fsm = segment(golden_dir, 2, 16)
    got = enc._analysis(blocks, fsm)
    ref = jlayer3.analyze_demand_fused(
        jnp.asarray(blocks.numpy()), jnp.asarray(fsm.numpy()), v, sf,
        enc.sfreq_hz)
    np.testing.assert_array_equal(np.asarray(ref["block_type"]),
                                  got["block_type"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["fsm_state"]),
                                  got["fsm_state"].numpy())
    assert int(ref["n_nonfinite"]) == int(got["n_nonfinite"]) == 0
    xr_ref = np.asarray(ref["xr"])
    assert np.abs(got["xr"].numpy() - xr_ref).max() \
        <= 1e-5 * np.abs(xr_ref).max()
    if version == "mpeg1":
        same = np.asarray(ref["scfsi"]) == got["scfsi"].numpy()
        assert same.mean() >= 0.9, same.mean()


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("version", VERSIONS)
def test_analysis_is_capture_safe(golden_dir, version, device):
    """The batched analysis under an aten-op log: no host read of a
    device value, no tensor from host data, every tensor of every op on
    the run's device (on "meta", whose values the host cannot read, as
    on the card)."""
    enc = Layer3SegmentEncoder(*VERSIONS[version], device)
    blocks, fsm = segment(golden_dir, 2, 16)
    blocks, fsm = blocks.to(device), fsm.to(device)
    with OpLog() as log:
        out = enc._analysis(blocks, fsm)
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 150
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device.type == device for t in out.values())


def _storage(t):
    return t.untyped_storage().data_ptr()


class PoolLog(TorchDispatchMode):
    """Every tensor an op allocates inside (an output on storage that none
    of its inputs has): what a captured graph would allocate in its
    memory pool (kept alive, so that no later tensor takes its
    address).  An in-place op's output, its own input, is not one."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {_storage(t) for t in tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        self.made += [t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)
                      and _storage(t) not in given]
        return out


def pooled_stand_in(pools):
    """A capture that records nothing: its replay runs fn eagerly, and
    the tensors it makes are logged in a new entry of `pools` (a graph's
    temporaries, which the next replay of any graph overwrites)."""
    def record(fn):
        def replay():
            with PoolLog() as log:
                fn()
            pools.append(log.made)
        return SimpleNamespace(replay=replay)
    return record


def shares_storage(t, made):
    return any(_storage(m) == _storage(t) for m in made)


@pytest.fixture
def analysis_graphs(monkeypatch):
    """An empty analysis cache of its own, and zeroed graph counts."""
    cache = graphs.GraphCache(4)
    monkeypatch.setattr(layer3, "GRAPHS", cache)
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    return cache


@pytest.mark.parametrize("version", VERSIONS)
def test_captured_analysis_equals_eager(golden_dir, analysis_graphs,
                                        version):
    """``analysis``'s host side with a stand-in capture, three calls on
    one key (the warm-up and capture, then replays, the second on other
    lanes): each call's results -- the entry's static outputs -- equal
    ``analysis_eager``'s exactly; they are written by copy into tensors
    made outside the replays (none shares storage with a tensor a replay
    made: an output left in the pool would be overwritten by the next
    graph); the first call's clones outlive the later replays."""
    enc = Layer3SegmentEncoder(*VERSIONS[version], "cpu")
    pools = []
    record = pooled_stand_in(pools)
    calls = [segment(golden_dir, 2, 32),
             segment(golden_dir, 2, 32, LANES[2:]), segment(golden_dir, 2, 32)]
    kept = []
    for blocks, fsm in calls:
        entry, dropped = enc._run_analysis(
            dict(blocks_h4=blocks, fsm_init=fsm), record)
        out = entry.outputs["analysis"]
        _assert_equal(out, enc.analysis_eager(blocks, fsm))
        if pools:
            assert not [k for k, v in out.items()
                        if shares_storage(v, pools[-1])]
        kept.append({k: v.clone() for k, v in out.items()})
        assert dropped == []
    assert len(analysis_graphs) == 1 and len(pools) == 2
    assert graphs.by_stage()["analysis"] == (1, 2)
    _assert_equal(kept[0], kept[2])
    assert not torch.equal(kept[0]["xr"], kept[1]["xr"])


def test_key_is_the_layout_and_the_tables(golden_dir):
    """Encoders of one rate share their tables, so one key; another rate,
    another lane count or width is another key."""
    blocks, fsm = segment(golden_dir, 2, 16)
    inputs = dict(blocks_h4=blocks, fsm_init=fsm)

    def key(enc, inp=inputs):
        return graphs.key_of(inp, *(enc.tables(g) for g in
                                    ("st", "psy", "dsp", "l3")))

    a = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    assert key(a) == key(Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu"))
    assert key(a) != key(Layer3SegmentEncoder(mpeg.MPEG1, 1, "cpu"))
    b4, f4 = segment(golden_dir, 4, 16)
    assert key(a) != key(a, dict(blocks_h4=b4, fsm_init=f4))
    assert key(a) != key(a, dict(blocks_h4=blocks[:, :12], fsm_init=fsm))


def test_equal_tables_are_one_set_of_tensors():
    """psy, dsp, bits and the segment program's own tables: equal tables
    on one device are the same tensors, another rate's psy tables are
    not."""
    a = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    b = Layer3SegmentEncoder(mpeg.MPEG1, 0, "cpu")
    for group in ("st", "psy", "dsp", "bits", "l3"):
        ta, tb = a.tables(group), b.tables(group)
        assert ta.keys() == tb.keys()
        assert all(ta[k] is tb[k] for k in ta
                   if isinstance(ta[k], torch.Tensor)), group
    assert psy.device_tables(psy.numpy_constants(44100.0), "cpu")["part_l"] \
        is a.tables("psy")["part_l"]
    assert dsp.device_tables(dsp.numpy_constants(), "cpu")["alias_t"] \
        is a.tables("dsp")["alias_t"]
    assert bits.device_tables("cpu")["pair_code"] is a.tables("bits")[
        "pair_code"]
    other = Layer3SegmentEncoder(mpeg.MPEG1, 1, "cpu").tables("psy")
    assert other["part_l"] is not a.tables("psy")["part_l"]
    assert other["dft_c1024"] is not a.tables("psy")["dft_c1024"]


@pytest.mark.parametrize("L", [2, 3])
def test_lane_automaton_equals_each_lane(L):
    """The block-type automaton of L lanes at once, each from its own
    state, equals each lane's own run (the same maps are tables of the
    psy group)."""
    PT = psy.device_tables(psy.numpy_constants(44100.0), "cpu")
    rng = np.random.RandomState(L)
    attack = torch.tensor(rng.rand(L, 37) < 0.3)
    init = torch.tensor([0, 2, 3][:L], dtype=torch.int32)
    emit, final = psy._fsm_blocktype(attack, init, PT)
    for i in range(L):
        e, f = psy._fsm_blocktype(attack[i], init[i], PT)
        assert torch.equal(emit[i], e) and int(final[i]) == int(f)


def test_per_lane_products_equal_one_lane_each():
    """``lanes.mm`` with a product in ``PER_LANE`` runs one product a
    lane: equal to each lane's own product."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(3, 5, 7).astype(np.float32))
    w = torch.tensor(rng.randn(7, 4).astype(np.float32))
    got = lanes.mm(x, w, "dft_c1024")
    assert "dft_c1024" in lanes.PER_LANE and got.shape == (3, 5, 4)
    for i in range(3):
        assert torch.equal(got[i], x[i] @ w)
    assert set(lanes.PER_LANE) <= set(lanes.PRODUCTS)


def test_loop_state_tables_unchanged():
    """The rate loop's tables (``loop.device_tables``) still share one
    set of tensors a device, through ``graphs.fingerprint``."""
    st = loop.static_tables(mpeg.MPEG1, 0)
    a = loop.device_tables(st, "cpu")
    b = loop.device_tables(dict(st), "cpu")
    assert all(a[k] is b[k] for k in a if isinstance(a[k], torch.Tensor))
