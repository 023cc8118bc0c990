"""The control -- the plain reference computed in bfloat16, put in the
program's place -- comes out not correct, on three seeds, at a size a
test run holds: each run judges the control on the streams that it
sampled from its window (``harness.run(control=True)``; readings of the
same kind were taken on the card at each cell's own size; PERF.md gives
them); the program's readings stay within every limit."""
import pytest

from conftest import tiny
from mp3bench import harness


@pytest.mark.parametrize("cell", ["l3-cd-128k.album", "l2-dab-192k.spots"])
def test_control_fails_program_passes(cell):
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        r = harness.run(cell, seed, 0.5, False, device="cpu", edit=tiny,
                        control=True)
        assert r["correct"]
        assert list(r)[-2:] == ["control", "check"]
        lim = {n: c["limit"] for n, c in r["check"].items()}
        assert r["control"]["mismatch_ppm"] > lim["mismatch_ppm"]


def test_cell_on_the_card(cuda):
    """One short run of the first cell on the card: correct, its metrics,
    the card named."""
    r = harness.run("l3-cd-128k.album", 2 ** 31 + 29, 1.0, False)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"setup_s", "audio_rtf"} <= set(r["metrics"])
