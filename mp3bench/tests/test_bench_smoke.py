"""The whole harness on the CPU at a tiny size: each cell's entry driven
with the kernels' plain versions, traced and untraced; correct, the
cell's metrics, and no device metric written."""
import pytest

from conftest import tiny
from mp3bench import harness

BENCH = harness.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
DEVICE = {m["name"] for m in BENCH["per_layer"]
          if m["source"] == "device_trace"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_cpu(cell, trace):
    r = harness.run(cell, 2 ** 31 + 17, 0.5, trace, device="cpu", edit=tiny)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["check"]["bad_frames"]["value"] == 0
    got = set(r["metrics"])
    if not trace:
        want = {m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", CELLS)}
        assert got == want
    else:
        want = {m["name"] for m in BENCH["per_layer"]
                if cell in m["workloads"]} - DEVICE
        assert got <= want and not got & DEVICE
        assert "busy_s" not in r["device"] and "breakdown" not in r
        assert 0 < r["metrics"]["host.unspanned_pct"]["value"] < 100
    assert r["device"]["platform"] == "cpu"
