"""The benchmark's tests: ``python -m pytest mp3bench/tests`` from the
checkout's root (tests marked ``cuda`` skip without a card)."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)


def tiny(traffic, config):
    """A cell's traffic cut to a CPU test's size: three short jobs of
    at most three clips, two jobs checked, ten frames each."""
    traffic["job_seconds"] = [min(s, 2.5) + 0.5 * i for i, s in
                              enumerate(traffic["job_seconds"][:3])]
    traffic["clips_per_job"] = min(traffic.get("clips_per_job", 1), 3)
    traffic["offset_step_s"] = 1.0
    traffic["pass_step_s"] = 0.7
    traffic["passes"] = 2
    traffic["master_s"] = 8.0
    traffic["check"] = dict(jobs=2, frames=10)
    traffic["trace_seconds"] = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
