"""Corpus lane-batch sweep (counterpart of ``tools/corpus_sweep.py``).

The corpus of ``bench_corpus.py`` (32 stereo 44.1 kHz 128 kbps clips x
10 s) through ``encode_corpus_batched`` at lane batches 1-16: per batch
one warm-up on two groups, then the aggregate real-time factor of the
whole corpus as the median of 3 runs, with its spread; and the
single-clip headline (the 60 s bench signal, median of 3 after one
warm-up) for comparison.  Groups run in order (the JAX tool's group
lookahead is not ported).

    python -m mp3tpu_torch.tools.corpus_sweep [--device cuda|cpu]
        [--clips 32] [--seconds 10] [--batches 1 2 4 8 16] [--runs 3]
        [--single-seconds 60] [out.json]

Prints the report as JSON on stdout; writes ``out.json`` only when
given.
"""
import argparse
import json
import statistics
import sys
import time

import torch

from ..config import EncoderConfig
from ..encoder import encode_layer3_fast
from ..parallel.corpus import encode_corpus_batched
from ..tables import mpeg
from . import describe, device_or_exit, sync
from .signals import make_clip, make_signal

RATE = 44100
#: the corpus's EncoderConfig keywords (the rate comes from the clips)
CORPUS_CFG = dict(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128)


def corpus(n_clips, seconds):
    """The corpus: [(pcm (2, samples) int16, rate)]."""
    return [(make_clip(s, seconds, RATE), RATE) for s in range(n_clips)]


def sweep(clips, batches, device, runs=3, around=None):
    """The corpus's aggregate real-time factor at each lane batch: one
    warm-up on the first two groups, then `runs` encodes of the whole
    corpus.  around(batch, i, encode), when given, makes run i (it calls
    encode() and returns its (outputs, stats)), so that a caller can
    count or check what each run does.  Returns one record a batch:
    lane_batch, aggregate_x_realtime (at the median wall), spread_x
    (slowest, fastest), wall_s (median), walls_s."""
    audio = sum(max(pcm.shape) / rate for pcm, rate in clips)
    around = around or (lambda batch, i, encode: encode())
    records = []
    for batch in batches:
        encode_corpus_batched(clips[:2 * batch], CORPUS_CFG, device,
                              batch=batch)
        walls = []
        for i in range(runs):
            _, stats = around(batch, i, lambda: encode_corpus_batched(
                clips, CORPUS_CFG, device, batch=batch))
            walls.append(stats["wall_s"])
        wall = statistics.median(walls)
        records.append({"lane_batch": batch,
                        "aggregate_x_realtime": audio / wall,
                        "spread_x": [audio / max(walls), audio / min(walls)],
                        "wall_s": wall, "walls_s": walls})
    return records


def single_clip(seconds, device, runs=3):
    """The real-time factor of the one-shot encode of the bench signal:
    median of `runs` after one warm-up."""
    pcm = make_signal(seconds, RATE)
    cfg = EncoderConfig(sample_rate_hz=RATE, **CORPUS_CFG)
    encode_layer3_fast(pcm, cfg, device=device)
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        encode_layer3_fast(pcm, cfg, device=device)
        ts.append(time.perf_counter() - t0)
    return seconds / statistics.median(ts)


def run(device, n_clips=32, seconds=10.0, batches=(1, 2, 4, 8, 16), runs=3,
        single_seconds=60.0):
    """The report of the sweep on `device`."""
    dev = torch.device(device)
    records = sweep(corpus(n_clips, seconds), batches, dev, runs)
    sync(dev)
    single = single_clip(single_seconds, dev, runs)
    best = max(records, key=lambda r: r["aggregate_x_realtime"])
    return {
        "corpus": f"{n_clips} clips x {seconds:g}s stereo 44.1kHz 128kbps, "
                  f"1 device",
        "device": describe(dev),
        "sweep": records,
        "best": best,
        "single_clip_seconds": single_seconds,
        "single_clip_x_realtime": single,
        "aggregate_vs_single_clip": best["aggregate_x_realtime"] / single,
        "note": ("aggregate real-time factor = the corpus's audio seconds "
                 "over the median wall of the runs (host clock, each run "
                 "ends with every stream on the host); groups of B clips "
                 "run in order as 2B lanes of one segment program"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.corpus_sweep",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--single-seconds", type=float, default=60.0)
    ap.add_argument("out", nargs="?", help="also write the report here")
    args = ap.parse_args(argv)
    dev = device_or_exit("corpus_sweep", args.device)
    report = run(dev, args.clips, args.seconds, args.batches, args.runs,
                 args.single_seconds)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
