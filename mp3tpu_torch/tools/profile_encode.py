"""Per-stage profile, FLOPs and device idle share of the bench encode
(counterpart of ``tools/profile_encode.py``).

Encodes the bench configuration (the bench signal, stereo 44.1 kHz
128 kbps) once to warm up, then once measured under
``runtime.profiling.trace`` (host seconds by named span, the spans of
``SPANS`` on torch.profiler's clock; on the card also the device kernels
and copies, busy and idle share of the measured wall), then once more
under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matmul
FLOPs (psy DFT, filterbank, MDCT, the rate loop's contractions) in
place of the JAX tool's XLA cost analysis; that encode runs the segment
program op by op (``tools.yardstick_form(rate_loop_eager=True)``), since
the counter sees no op of a replayed CUDA graph.  The measured run's
CUDA graph captures and replays are reported by stage.

    python -m mp3tpu_torch.tools.profile_encode [--device cuda|cpu]
        [--seconds 60] [out.json]

Prints the record as JSON on stdout; writes ``out.json`` only when
given.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config import EncoderConfig
from ..encoder import encode_layer3_fast
from ..ops import graphs
from ..runtime.profiling import Profiler, trace
from ..tables import mpeg
from . import (FP32_OPS_PER_S, busy_s, describe, device_events,
               device_or_exit, sync, yardstick_form)
from .signals import make_signal
from .trace_stages import span_breakdown


def run(seconds, device):
    """The record for the bench signal of `seconds` on `device`."""
    dev = torch.device(device)
    pcm = make_signal(seconds, 44100)

    def encode(prof=None):
        cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                            bitrate_kbps=128, sample_rate_hz=44100)
        out = encode_layer3_fast(pcm, cfg, device=dev, prof=prof)
        sync(dev)
        return out

    t0 = time.perf_counter()
    encode()
    warm = time.perf_counter() - t0

    prof = Profiler()
    got = {}

    def measured():
        t0 = time.perf_counter()
        got["out"] = encode(prof)
        got["wall"] = time.perf_counter() - t0

    events = busy = None
    graphs.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, dev) as tp:
            measured()
        spans = span_breakdown(os.path.join(tmp, "trace.json"))["spans"]
    stages = {n: r["host_s"] for n, r in spans.items() if r["count"]}
    if dev.type == "cuda":
        events = device_events(tp)
        busy, events = busy_s(events), len(events)
    wall = got["wall"]
    by_stage = graphs.by_stage()

    # a replayed CUDA graph runs no aten op that the counter could see:
    # the counted encode runs op by op (the same arithmetic)
    with yardstick_form(rate_loop_eager=True), \
            FlopCounterMode(display=False) as counter:
        encode()
    flops = int(counter.get_total_flops())
    on_card = dev.type == "cuda"
    return {
        "config": "layer3 stereo 44.1kHz 128kbps",
        "clip_seconds": seconds,
        "backend": dev.type,
        "device": describe(dev),
        "warmup_s": warm,
        "wall_s": wall,
        "x_realtime": seconds / wall,
        "bytes": len(got["out"]),
        "stages_s": stages,
        "meta": prof.meta,
        "flop_counter_flops": flops,
        "mfu_vs_fp32_peak": (flops / wall / FP32_OPS_PER_S
                             if on_card else None),
        "mfu_note": (
            "torch.utils.flop_counter.FlopCounterMode FLOPs of one encode "
            "(matmuls only: psy DFT, filterbank, MDCT and the rate loop's "
            "contractions; the bits_at kernel, the elementwise work and the "
            "host are not counted, so this lower-bounds the work) / the "
            "measured wall / 67 TFLOP/s, an H100 SXM's float32 peak outside "
            "the tensor cores (TF32 is off); None off the card.  The encode "
            "is a branch-heavy rate search, launch-bound on the host, so "
            "x_realtime is the meaningful metric"),
        "graphs_by_stage": by_stage,
        "device_events": events,
        "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall if on_card else None,
        "note": ("the measured run is traced (torch.profiler CPU and CUDA "
                 "activity): its wall includes the profiler's cost"
                 if on_card else "a CPU run: no device metric"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.profile_encode",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("out", nargs="?", help="also write the record here")
    args = ap.parse_args(argv)
    dev = device_or_exit("profile_encode", args.device)
    record = run(args.seconds, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
