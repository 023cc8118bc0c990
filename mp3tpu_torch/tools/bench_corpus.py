"""Corpus throughput benchmark of the port (counterpart of bench_corpus.py).

The aggregate encode rate over many clips: the clips of
``bench_corpus.py`` (stereo 44.1 kHz, 128 kbps) through
``encode_corpus_batched``, `batch` clips at a time as the lanes of one
segment program, at a group lookahead of 3 (``LOOKAHEAD``: three groups
queued on the card while the host assembles the oldest, the default of
``bench_corpus.py``'s JAX encode); one warm-up on the first group, then
one timed encode of the whole corpus.

    python -m mp3tpu_torch.tools.bench_corpus [n_clips] [seconds] [batch]
        [--device cuda|cpu]

(defaults 20, 10 and 2).  Prints one JSON line with ``bench_corpus.py``'s
keys -- metric, value (the corpus's audio seconds over the wall of the
timed encode, ending with every stream on the host), unit, vs_baseline
(against the reference C encoder's 33.1x on one CPU core) -- and
``device``: the card's name and power limit as nvidia-smi gives them.
Writes no file.
"""
import argparse
import json
import sys

import torch

from ..parallel.corpus import encode_corpus_batched
from . import describe, device_or_exit
from .bench import BASELINE_RT
from .corpus_sweep import CORPUS_CFG, corpus

#: the corpus groups in flight (``encode_corpus_batched(lookahead=)``), the
#: JAX package's default ``MP3TPU_CORPUS_LOOKAHEAD``
LOOKAHEAD = 3


def _check(outs):
    if min(map(len, outs)) <= 1000:
        raise RuntimeError(f"bench_corpus: a stream of "
                           f"{min(map(len, outs))} bytes")


def run(n_clips, seconds, batch, device):
    """One warm-up group and one timed encode of the corpus on `device`, at
    a lookahead of ``LOOKAHEAD`` groups; returns (record, the timed
    encode's streams)."""
    dev = torch.device(device)
    clips = corpus(n_clips, seconds)
    outs, _ = encode_corpus_batched(clips[:batch], CORPUS_CFG, dev,
                                    batch=batch, lookahead=LOOKAHEAD)
    _check(outs)
    outs, stats = encode_corpus_batched(clips, CORPUS_CFG, dev, batch=batch,
                                        lookahead=LOOKAHEAD)
    _check(outs)
    rt = stats["x_realtime"]
    return {
        "metric": "layer3 corpus aggregate realtime factor "
                  f"({n_clips} clips x {seconds:.0f}s, stereo 128kbps, "
                  f"lane-batch {batch}, 1 chip)",
        "value": round(rt, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rt / BASELINE_RT, 3),
        "device": describe(dev),
    }, outs


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mp3tpu_torch.tools.bench_corpus",
        description=__doc__.splitlines()[0])
    ap.add_argument("n_clips", nargs="?", type=int, default=20)
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("batch", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_or_exit("bench_corpus", args.device)
    record, _ = run(args.n_clips, args.seconds, args.batch, dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
