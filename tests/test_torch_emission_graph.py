"""The final encode's emission and packing as the rate loop's captured
continuation, checked on the CPU (``models/layer3.py``, ``ops/loop.py``).

On a CUDA tensor ``Layer3SegmentEncoder.encode_final`` hands
``_emission`` (the signed spectrum, ``granule_payload``,
``compact_payload``, ``pack_state``) to ``loop.outer_loop`` as a
``loop.Then``: it is captured once per loop key and emission key and
replayed after the loop's last iteration, reading the loop's static
tensors.  These tests check that ``_emission`` can be captured (an
aten-op log on "cpu" and "meta"); run the captured loop's host side
(``loop._run_captured`` with the continuation) with a stand-in capture
against ``encode_final_eager`` (the emission op by op after the loop:
what the CPU runs) call after call on one key, MPEG-1 with its scfsi
masks and LSF, rows and the compacted buffer, its results written into
static tensors that no replay's temporaries are; a wider payload row is
a new emission graph of the same loop entry; and on the CPU
``encode_final`` is ``encode_final_eager``.  The graphs themselves run
on the card (tests/test_torch_analysis_graph_card.py, chip_smoke.py
phase 5c).
"""
import pytest
import torch

from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from mp3tpu_torch.ops import bits, graphs, loop
from mp3tpu_torch.tables import mpeg
from test_torch_analysis_graph import (VERSIONS, PoolLog, pooled_stand_in,
                                       segment, shares_storage)
from test_torch_graph import HOST_DATA, HOST_READS, OpLog

torch.set_num_threads(1)

S = 32


@pytest.fixture(scope="module", params=list(VERSIONS))
def final_case(request, golden_dir):
    """(version name, encoder, encode_final's arguments) of a stereo
    segment: the analysis and demand encode on the CPU, budgets cut to
    70% of the demand where it exceeds 300 bits."""
    version = request.param
    enc = Layer3SegmentEncoder(*VERSIONS[version], "cpu")
    blocks, fsm = segment(golden_dir, 2, S)
    ana = enc.analyze_demand_fused(blocks, fsm)
    p23 = ana["p23"].to(torch.float32)
    budget = torch.where(p23 > 300, torch.floor(p23 * 0.7), 4095.0)
    args = dict(xr=ana["xr"], ratio_l=ana["ratio_l"],
                ratio_s=ana["ratio_s"], block_type=ana["block_type"],
                budget=budget, scfsi=ana.get("scfsi"),
                sf_fix=ana.get("sf_fix"), nch=2, qss_lo=ana["qss"])
    return version, enc, args


#: a flat buffer that holds a stereo segment of S granules at 128 kbps
CAP = bits.payload_cap_words(S // 2, 3344, 256, 4088, 2 * S)


def _assert_equal(got, ref):
    assert got.keys() == ref.keys() == {"side", "payload"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_emission_is_capture_safe(final_case, device):
    """``_emission`` (and the epilogue it reads) under an aten-op log: no
    host read, no tensor from host data, every op on the run's device."""
    version, enc, args = final_case
    cpu_args = enc._final_args(**args)
    out = loop.outer_loop(ST=enc.tables("st"), **cpu_args)
    dev_enc = Layer3SegmentEncoder(*VERSIONS[version], device)
    inputs = {k: None if v is None else v.to(device)
              for k, v in cpu_args.items()}
    out = {k: v.to(device) for k, v in out.items()}
    with OpLog() as log:
        got = dev_enc._emission(out, inputs, 96, CAP)
    names = {op for op, _ in log.ops}
    assert len(log.ops) > 100
    assert not names & HOST_READS, names & HOST_READS
    assert not names & HOST_DATA, names & HOST_DATA
    elsewhere = [(op, devs) for op, devs in log.ops if devs - {device}]
    assert not elsewhere, elsewhere[:5]
    assert all(t.device.type == device for t in got.values())


@pytest.fixture
def loop_graphs(monkeypatch):
    """An empty rate-loop cache of its own, and zeroed graph counts."""
    cache = graphs.GraphCache(loop.GRAPH_CACHE_SIZE)
    monkeypatch.setattr(loop, "GRAPHS", cache)
    monkeypatch.setattr(graphs, "graph_counts", {
        s: dict(captures=0, replays=0) for s in graphs.STAGES})
    return cache


def _calls(args):
    """Three final encodes of one key: the case, its budgets cut further,
    the case again."""
    other = dict(args, budget=torch.where(args["budget"] < 4095,
                                          torch.floor(args["budget"] * 0.8),
                                          args["budget"]))
    return [args, other, args]


@pytest.mark.parametrize("flat", [False, True], ids=["rows", "compacted"])
def test_captured_emission_equals_eager(final_case, loop_graphs, flat):
    """The captured loop with the emission continuation, stand-in
    capture, three calls on one key: each call's side table and payload
    (the continuation's static outputs) equal ``encode_final_eager``'s;
    none shares storage with a tensor a replay made (an output left in
    the graphs' pool would be overwritten by the next replay); one
    capture and two replays of the emission."""
    version, enc, args = final_case
    cap = CAP if flat else None
    pools = []
    record = pooled_stand_in(pools)
    kept = []
    for call in _calls(args):
        n = len(pools)
        _, dropped, out = loop._run_captured(
            enc._final_args(**call), enc.tables("st"), 6, record,
            then=enc._then(96, cap))
        _assert_equal(out, enc.encode_final_eager(
            payload_words=96, flat_cap=cap, **call))
        if len(pools) > n:
            assert not [k for k, v in out.items()
                        if shares_storage(v, pools[-1])]
        kept.append({k: v.clone() for k, v in out.items()})
        assert dropped == []
    assert len(loop_graphs) == 1
    assert graphs.by_stage()["emission"] == (1, 2)
    assert graphs.by_stage()["prologue"] == (1, 2)
    _assert_equal(kept[0], kept[2])
    assert not torch.equal(kept[0]["side"], kept[1]["side"])


def test_wider_rows_are_another_emission_graph(final_case, loop_graphs):
    """A re-bucketed retry (wider payload rows) on the same loop key is a
    new emission graph of the same loop entry, equal to the eager form."""
    version, enc, args = final_case
    for pw in (96, 128, 96):
        _, _, out = loop._run_captured(
            enc._final_args(**args), enc.tables("st"), 6,
            pooled_stand_in([]), then=enc._then(pw, None))
        _assert_equal(out, enc.encode_final_eager(payload_words=pw, **args))
        assert out["payload"].shape == (2 * S, pw)
    assert len(loop_graphs) == 1
    assert graphs.by_stage()["emission"] == (2, 1)


def test_encode_final_on_the_cpu_is_the_eager_form(final_case,
                                                   loop_graphs):
    version, enc, args = final_case
    cap = CAP
    _assert_equal(enc.encode_final(payload_words=96, flat_cap=cap, **args),
                  enc.encode_final_eager(payload_words=96, flat_cap=cap,
                                         **args))
    assert len(loop_graphs) == 0 and graphs.totals() == dict(captures=0,
                                                             replays=0)
    if version == "mpeg1":
        assert int(args["scfsi"].sum()) > 0, "the case sends no scfsi"


def test_pool_log_sees_a_kept_temporary():
    """The pool check itself: a result that is a replay's own temporary
    shares storage with what the replay made; a copy into a tensor made
    before does not."""
    static = torch.zeros(4)
    with PoolLog() as log:
        temp = torch.arange(4.0) * 2
        static.copy_(temp)
    assert shares_storage(temp, log.made)
    assert not shares_storage(static, log.made)


def test_mpeg1_case_uses_both_masks(final_case):
    """The MPEG-1 case fixes and skips scalefactor bands (the emission's
    skip mask is the loop's static input); LSF has neither."""
    version, enc, args = final_case
    a = enc._final_args(**args)
    if version == "mpeg1":
        assert a["sf_fix_mask"].any() and a["sf_skip_mask"].any()
    else:
        assert a["sf_fix_mask"] is None and a["sf_skip_mask"] is None
    assert enc.tables("st")["lsf"] == (VERSIONS[version][0]
                                       == mpeg.MPEG2_LSF)
