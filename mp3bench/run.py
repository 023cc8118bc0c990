"""Run one cell of the benchmark once:

    python3 mp3bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result, one JSON object; the
check's numbers, each beside its limit, are the last lines of standard
error.  ``--control 1`` also reports the control's numbers (the plain
reference in bfloat16 in the program's place, judged on the same
streams), the readings that the limits are set from; the benchmark's
own runs leave it off.  Exits non-zero, with no result, without the CUDA devices that
the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or ``mp3tpu``
were loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, heads the path: the benchmark's
# modules are imported as mp3bench.*, and none shadows a standard one
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from mp3bench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    res = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=T_START, control=bool(a.control))
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
