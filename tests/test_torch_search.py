"""K3's wrapper on the CPU: the searches' dispatch, input checks, the
constants it shares with csrc/bits_at.cu, and the CPU searches against
the code they replaced.  The kernel against the plain searches is in
tests/test_torch_search_card.py; the searches' algorithm against the JAX
package in tests/test_torch_search_model.py."""
import json
import re

import pytest
import torch

from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop, search
from mp3tpu_torch.tables import mpeg
from mp3tpu_torch.tools import trace_stages
from test_torch_search_card import (CASES, case_args, run_search,
                                    search_case, search_mismatches)

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)


# ---- the lockstep searches as they were written before K3 (the JAX
# package's loops, each evaluation one loop._bits_at)

def _walk_up_before(xr75p, budget, qss, bits, is_short, is_short_block, ST,
                    max_steps):
    it = 0
    while it < max_steps and bool((bits > budget).any()):
        bad = bits > budget
        qss = torch.where(bad, qss + 1.0, qss)
        b2 = loop._bits_only(xr75p, qss, is_short, is_short_block, ST)
        bits = torch.where(bad, b2, bits)
        it += 1
    return qss, bits


def _search_walk_before(xr75p, budget, start_qss, is_short, is_short_block,
                        ST, max_steps=40):
    bits = loop._bits_only(xr75p, start_qss, is_short, is_short_block, ST)
    qss, bits = _walk_up_before(xr75p, budget, start_qss, bits, is_short,
                                is_short_block, ST, max_steps)
    bits, c = loop._bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


def _search_stepsize_before(xr75p, budget, qanf, is_short, is_short_block,
                            ST, n_bisect=8, qss_lo=None):
    floor_q = torch.clamp(qanf, min=loop.QMIN)
    lo = floor_q if qss_lo is None else torch.maximum(floor_q, qss_lo)
    hi = torch.full_like(lo, loop.QMAX)
    for _ in range(n_bisect):
        mid = torch.floor((lo + hi) * 0.5)
        ok = loop._bits_only(xr75p, mid, is_short, is_short_block,
                             ST) <= budget
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    qss = hi
    bits = loop._bits_only(xr75p, qss, is_short, is_short_block, ST)
    qss, bits = _walk_up_before(xr75p, budget, qss, bits, is_short,
                                is_short_block, ST, 40)
    for _ in range(3):
        qss2 = qss - 1.0
        b2 = loop._bits_only(xr75p, qss2, is_short, is_short_block, ST)
        good = (b2 <= budget) & (qss2 >= floor_q)
        qss = torch.where(good, qss2, qss)
        bits = torch.where(good, b2, bits)
    bits, c = loop._bits_at(xr75p, qss, is_short, is_short_block, ST)
    return qss, bits, c


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_cpu_searches_return_what_they_returned_before(name):
    """loop.search_stepsize / search_walk on a CPU tensor: the lockstep
    plain search, equal to the code before K3 on every output it had; the
    counts gain each granule's evaluations."""
    kind, args, kwargs = case_args(search_case(name, 80, 17), "cpu")
    launches = (search.launches, K.bits_at.launches)
    if kind == "stepsize":
        got = loop.search_stepsize(*args, **kwargs)
        want = _search_stepsize_before(*args, **kwargs)
    else:
        got = loop.search_walk(*args, **kwargs)
        want = _search_walk_before(*args, **kwargs)
    assert (search.launches, K.bits_at.launches) == launches
    assert not search_mismatches(got, want)
    assert set(got[2]) == set(want[2]) | {"evals"}
    assert not search_mismatches(got, run_search(kind, args, kwargs,
                                                 plain=True))
    base = 13 if kind == "stepsize" else 2
    evals = got[2]["evals"]
    assert evals.dtype == torch.int32
    assert int(evals.min()) >= base and int(evals.max()) <= base + 40


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "contiguous",
                                  "flags", "qss_lo", "unsupported", "width"])
def test_wrapper_refuses_bad_inputs_before_any_launch(case):
    kind, args, _ = case_args(search_case("stepsize", 16, 2), "cpu")
    xr75p, budget, qanf, short, wsf, ST = args
    kwargs = {}
    if case == "dtype":
        err, args = TypeError, (xr75p, budget.double(), qanf, short, wsf)
    elif case == "shape":
        err, args = ValueError, (xr75p, budget, qanf[:15].contiguous(),
                                 short, wsf)
    elif case == "device":
        err, args = ValueError, (xr75p, budget.to("meta"), qanf, short, wsf)
    elif case == "contiguous":
        err, args = ValueError, (xr75p.t().contiguous().t(), budget, qanf,
                                 short, wsf)
    elif case == "flags":
        err, args = TypeError, (xr75p, budget, qanf, short, wsf.to(torch.int8))
    elif case == "qss_lo":
        err, args = TypeError, (xr75p, budget, qanf, short, wsf)
        kwargs = {"qss_lo": qanf.to(torch.int32)}
    elif case == "width":
        err, args = ValueError, (xr75p, budget, qanf, short, wsf)
        kwargs = {"width": search.MAX_WIDTH + 1}
    else:
        err, args = ValueError, tuple(t.to("meta") for t in
                                      (xr75p, budget, qanf, short, wsf))
    before = search.launches
    with pytest.raises(err):
        search.search_stepsize(*args, ST, **kwargs)
    if case != "qss_lo":                    # the walk takes no qss_lo
        with pytest.raises(err):
            search.search_walk(*args, ST, **kwargs)
    if case == "width":
        for width in (0, -1):
            with pytest.raises(err):
                search.search_walk(*args, ST, width=width)
    assert search.launches == before


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    st = loop.static_tables(mpeg.MPEG1, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        loop.device_tables(st, "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        search._istep_table(torch.device("cuda"))


def test_constants_match_the_cuda_source():
    """The kernel's rows, its stepsize table and the searches' bounds, as
    csrc/bits_at.cu declares them, against the Python side."""
    with open(K.SOURCE) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr (?:int|float) (k\w+) = ([^;]+);",
                            src))
    assert const["kSearchOut"] == "kOut + 4" == f"kOut + "\
        f"{len(search.EXTRA_ROWS)}"
    assert int(const["kMaxWidth"]) == search.MAX_WIDTH
    # the rows after bits_at's, in the order the kernel's lanes write them
    for i, row in enumerate(search.EXTRA_ROWS):
        value = {"qss": "__float_as_int(qss)",
                 "evals": "walk ? steps + 2 : n_bisect + 5 + steps"}.get(row,
                                                                        row)
        assert re.search(rf"lane == kOut(?: \+ {i})?\)\s+out\[at\] = "
                         rf"{re.escape(value)};", src), row
    assert int(const["kStepLo"]) == search.STEP_LO
    assert int(const["kStepCount"]) == search.STEP_HI - search.STEP_LO + 1
    assert float(const["kQMin"].rstrip("f")) == loop.QMIN
    assert float(const["kQMax"].rstrip("f")) == loop.QMAX
    assert int(const["kDownSteps"]) == 3
    for entry in ("mp3_search", "mp3_search_plan"):
        assert f"extern \"C\" int {entry}(" in src
    assert search.EXTRA_ROWS == ("qss", "evals", "status", "runs")


def test_istep_table_is_torch_exp2_of_each_stepsize():
    q = torch.arange(search.STEP_LO, search.STEP_HI + 1, dtype=torch.float32)
    tab = search._istep_table(torch.device("cpu"))
    assert tab.dtype == torch.float32 and tab.shape == (1024,)
    assert torch.equal(tab, torch.exp2(-0.1875 * q))
    assert tab[-search.STEP_LO] == 1.0 and tab[16 - search.STEP_LO] == 0.125


def test_span_breakdown_counts_k3_events(tmp_path):
    """A hand-made trace: one bits_at and two K3 kernels, by name."""
    def x(cat, name, ts, corr):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=1,
                    args={"correlation": corr})
    events = [x("user_annotation", "outer_loop", 0, None),
              x("cuda_runtime", "cuLaunchKernel", 1, 1),
              x("cuda_runtime", "cuLaunchKernel", 2, 2),
              x("cuda_runtime", "cuLaunchKernel", 3, 3),
              x("kernel", "(anonymous namespace)::bits_at_kernel(float4 "
                "const*)", 10, 1),
              x("kernel", "(anonymous namespace)::search_kernel(float4 "
                "const*)", 11, 2),
              x("kernel", "(anonymous namespace)::search_kernel(float4 "
                "const*)", 12, 3)]
    events[0]["dur"] = 5
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    bd = trace_stages.span_breakdown(str(path))
    assert (bd["bits_at_kernel_events"], bd["search_kernel_events"]) == (1, 2)
    assert bd["spans"]["outer_loop"]["device_events"] == 3
