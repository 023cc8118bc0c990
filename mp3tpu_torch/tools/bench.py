"""Headline benchmark of the port (counterpart of ``bench.py``).

The Layer III encode's real-time factor on one device.  Encodes the
synthetic stereo clip of ``bench.py`` (60 s by default) at 128 kbps with
``encode_layer3_fast`` -- the segment programs on the device, the
reservoir scan and the native assembly on the host -- after one warm-up
encode (which also builds the kernels), then five timed encodes, each on
the host clock from the call until its bytes are back on the host.

    python -m mp3tpu_torch.tools.bench [seconds] [--device cuda|cpu]

Prints one JSON line with ``bench.py``'s keys -- metric, value (clip
seconds over the median wall), unit, vs_baseline (against the reference
C encoder's 33.1x on one CPU core, BASELINE.md), spread_x (clip seconds
over the slowest and the fastest wall) -- and ``device``: the card's
name and power limit as nvidia-smi gives them.  Writes no file.
"""
import argparse
import json
import sys
import time

import torch

from ..config import EncoderConfig
from ..encoder import encode_layer3_fast
from ..tables import mpeg
from . import describe, device_or_exit
from .signals import make_signal

#: the reference C encoder's real-time factor on one CPU core (BASELINE.md)
BASELINE_RT = 33.1
#: bench.py's metric string
METRIC = "layer3 encode realtime factor (stereo 44.1kHz 128kbps, 1 chip)"
RATE = 44100


def run(seconds, device, runs=5):
    """One warm-up encode of the bench signal and `runs` timed ones on
    `device`; returns (record, the last timed stream)."""
    dev = torch.device(device)
    pcm = make_signal(seconds, RATE)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=RATE)
    out = encode_layer3_fast(pcm, cfg, dev)
    if len(out) <= 1000:
        raise RuntimeError(f"bench: the warm-up encode gave {len(out)} bytes")
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = encode_layer3_fast(pcm, cfg, dev)
        times.append(time.perf_counter() - t0)
    times.sort()
    rt = seconds / times[len(times) // 2]
    return {
        "metric": METRIC,
        "value": round(rt, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rt / BASELINE_RT, 3),
        "spread_x": [round(seconds / times[-1], 1),
                     round(seconds / times[0], 1)],
        "device": describe(dev),
    }, out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("seconds", nargs="?", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_or_exit("bench", args.device)
    record, _ = run(args.seconds, dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
