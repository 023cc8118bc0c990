"""The result line: the contract's keys in order, the check's numbers
last; the command without a card exits non-zero and prints nothing on
standard output; so does a checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny
from mp3bench import harness


def test_line_keys_and_check_last(capsys):
    r = harness.run("l2-dab-192k.spots", 2 ** 31 + 5, 0.5, False,
                    device="cpu", edit=tiny)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "check"]
    assert set(r["metrics"]) == {"setup_s", "audio_rtf", "job_p95_ms"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(r["check"]) == ["bad_frames", "mismatch_ppm"]
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("check bad_frames ")
    assert err[-1].startswith("check mismatch_ppm ")
    json.dumps(r)


@pytest.mark.parametrize("only_bench", [False, True])
def test_no_card_no_result(tmp_path, only_bench):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cwd = ROOT
    if only_bench:
        cwd = tmp_path / "c"
        shutil.copytree(os.path.join(ROOT, "mp3bench"), cwd / "mp3bench")
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), cwd)
    out = subprocess.run(
        [sys.executable, "mp3bench/run.py", "--workload",
         "l3-cd-128k.album", "--seed", str(2 ** 31 + 1), "--seconds", "10",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
