"""The port's measurement and quality tools, each run as
``python -m mp3tpu_torch.tools.<name> [--device cuda|cpu] ...``:

- ``quality``: the 15 decoded-SNR fixtures on the device, against the
  reference encoder's bars and through libmpg123;
- ``trace_stages``: the end-to-end wall, each segment stage in isolation,
  this card's link and launch costs, and optionally a trace;
- ``profile_encode``: the stage profile, matmul FLOPs and device idle
  share of the bench encode;
- ``corpus_sweep``: the corpus's aggregate real-time factor by lane
  batch.

Each runs on the card unless ``--device cpu`` is given (without a card
``--device cuda`` exits non-zero; there is no fall back to the CPU),
prints its report as JSON on stdout and writes a file only to a path it
is given.  ``signals`` holds the benchmark scripts' signals.
"""
import math
import subprocess
import sys
import time

import torch

#: NVIDIA H100 SXM, data sheet: HBM rate, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def device_or_exit(prog, device):
    """``resolve_device(device)``, or exit non-zero with the reason (a
    CUDA device was asked for and there is none)."""
    from .. import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        sys.exit(f"{prog}: {e}")


def describe(dev):
    """What a report ran on: for CUDA the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them (the power
    limit sets the card's speed under load), else the device."""
    if dev.type != "cuda":
        return str(dev)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def sync(dev):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_once(fn):
    """One fn() under torch.profiler's CUDA activity: (device kernels and
    copies, device busy s, profiled wall s).  Busy is the union of the
    device events' intervals; the wall is the host clock around fn and a
    synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return len(spans), busy_us / 1e6, wall
