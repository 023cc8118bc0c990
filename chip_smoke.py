#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mp3tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build both kernel libraries, K1 (mp3tpu_torch/csrc/hist_c1.cu) and
     bits_at with K3 (csrc/bits_at.cu, with -Xptxas -v, whose report is
     printed), one nvcc process each, started together; timed;
  3. K1 against its plain PyTorch version on the card, bit for bit, on
     random quantized batches at G = 512, 4096 (the main path's segment
     widths) and 4099, then both timed: device time per call from
     torch.profiler, and call time with CUDA events (median);
  3b. bits_at, the rate loop's whole bit evaluation in one launch,
     against its plain chain (bits_at_plain), torch.equal on every
     output: random batches of long, short and start/stop granules at
     G = 512, 4096 and 4099 (about a quarter past IXMAX) and at 16384
     and 65536 (how its time scales with the batch), one with
     MPEG-2 LSF 22.05 kHz tables, one wholly past IXMAX, and the main
     path's own first 4096-lane evaluation (the first stepsize of its
     first 4096-lane stepsize search, captured at the search's entry) at
     six stepsizes; timed (kernel device and call time, the plain chain's
     device time, K1's device time on the same quantized batch) beside
     the bound;
  3c. K3, the stepsize searches in one launch each, at the width (warps
     a granule) its launch picks and at widths 1, 2, 3, 4 and 7, and
     K3's first design kept as the baseline, against the lockstep plain
     searches on bits_at: torch.equal on qss, bits, every count row and
     the evaluation counts, status 0: random stepsize and walk batches at
     G = 512, 4096, 4099, 16384 and 65536, LSF batches, a qss_lo batch,
     a walk and a stepsize batch driven into the 40-step cap, and the
     main path's own first 4096- and 512-lane stepsize searches and
     walks; timed: the baseline and K3 in turns (device time), K3 at
     each width, both call times, the evaluations the plain schedule
     counts against those K3 runs, the plain search's device time, call
     time and bits_at launches, beside the bound (the larger of the
     bytes' and the operations' time) and each design's share of it;
  4. the 15 quality fixtures of tests/test_fast_encoder.py through the
     quality tool (mp3tpu_torch.tools.quality, encode_layer3_fast on
     "cuda"): frame grid and the reference encoder's decoded-SNR bars
     (in-repo decoder), and libmpg123's best-lag SNR when it is present;
  5. the main path: the 60 s stereo 44.1 kHz 128 kbps clip of bench.py
     (its signal, copied here), encoded five ways: with loop's searches
     swapped (by this script) for the lockstep plain searches and
     loop._bits_at for the plain chain, then for the chain of K1 with
     plain PyTorch around it, then the plain searches on bits_at (the
     lockstep path), then K3's first design (the baseline), then as the
     package runs it (K3), each with the launch counts reset before and
     read after (each swap must show in them); the five streams must be
     equal byte for byte, and K3's evaluation counts must give the
     lockstep path's bits_at launches.
     Then the lockstep path and the package in 5 ABBA turns (10 timed runs
     each), one encode of each under torch.profiler (device kernels and
     copies, device idle share), and the searches' kernel's device time
     summed over one encode, K3 and the baseline in turns; the stream
     must sit on the frame grid and its first 10 s must decode within
     1 dB of the CPU path's 10 s encode;
  6. MPEG-2 LSF: the three 0.5 s mono cases of tests/test_lsf.py, then a
     60 s stereo 24 kHz 64 kbps clip (launches and syncs counted), interior
     frames on the grid, first 10 s within 1 dB of the CPU path;
  7. streaming: the bench clip in 1 s pieces through StreamEncoder at
     window 1024 (launches counted, timed) must equal the one-shot
     encode at chunk 1024 byte for byte, and so must a run checkpointed
     at 30 s, pickled and resumed in a fresh encoder;
  8. Layers I/II: the six fixtures of tests/test_layer12_fast.py and its
     CRC case, then a 60 s stereo 44.1 kHz Layer II 192 kbps clip (frame
     grid, timed, first 10 s within 0.5 dB of the CPU path);
  9. the command line: python -m mp3tpu_torch on a 10 s WAV and on raw
     PCM piped to stdin must write the library's bytes;
  10. corpus: 32 stereo 44.1 kHz 128 kbps clips x 10 s (bench_corpus.py's
     clips) through encode_corpus_batched at lane batch 1, 2, 4, 8 and 16
     by the corpus sweep tool (mp3tpu_torch.tools.corpus_sweep.sweep): one
     warm-up and 3 timed runs each (aggregate real-time factor, K3
     launches per group, equal outputs, frame grid); one group of 1 and
     one of 16 split into analysis, rate loop and the rest (wall between
     synchronizes, device kernels by stage); the eight stereo 44.1 kHz
     128 kbps quality fixtures as one mixed-length group, each at its bar
     and within 0.5 dB of its one-shot encode; K3 (each width) and the
     baseline against the plain search on the first 32,768-lane stepsize
     search of a group of 16, timed as in phase 3c, and bits_at against
     its plain chain at its first stepsize, timed;
  11. multi-device: dryrun_multichip(1) on an NCCL mesh, then the 60 s
     clip through encode_layer3_sharded at world size 1 (NCCL, this
     process) and 2 (gloo, two processes of this script run with
     --sharded-rank, both computing on cuda:0): equal length, equal block
     types and first-10 s SNR within 0.5 dB of the one-shot encode at the
     same chunk, both ranks' bytes equal; timed, kernels counted; K3
     against the plain search on each run's own first stepsize search
     (9,216 lanes at world size 1, 4,608 on each rank at 2) and bits_at
     against its plain chain at three stepsizes of that batch;
  12. tooling: runtime.profiling.trace around one 60 s bench encode into
     a temporary directory (trace.json parses, every named program span
     of runtime.profiling.SPANS is in it, its search_kernel and
     bits_at_kernel events equal search.launches and bits_at.launches of
     that encode, the same bytes as phase 5; per span
     its count, host wall and the device events launched inside it), the
     trace_stages and profile_encode tools on the 60 s clip (their JSON
     printed), and libmpg123 on the 60 s main-path, LSF and Layer II
     streams (rate, channels, length; its best-lag SNR over the clip and
     over the first 10 s, against the in-repo decoder's on the first 10 s
     and the two decoders' agreement).
On every path (main, LSF, stream, corpus, sharded) K3 must launch and the
rate loop must launch bits_at and the baseline no time; the launches and
loop-exit syncs per path are printed.  Its last lines are a JSON object
describing the kernels and then {"ok": true, "device": {...}}.  It
imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mp3tpu_torch.tools import (FP32_OPS_PER_S,  # noqa: E402
                                HBM_BYTES_PER_S, profile_once)
from mp3tpu_torch.tools.signals import make_signal  # noqa: E402

CLIP_SECONDS = 60.0
TIMED_RUNS = 3
#: phase 5 times the lockstep path and K3 in this many ABBA turns (2 runs each)
TURNS = 5
#: the widths (warps a granule) at which phase 3c checks and times K3
WIDTHS = (1, 2, 3, 4, 7)
#: NVIDIA H100 SXM: 64 int32 lanes an SM on 132 SMs at the 1.98 GHz boost
#: clock (the float32 rate of mp3tpu_torch.tools counts 128 lanes and an
#: FMA as two)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the operations that one K3 evaluation cannot avoid (csrc/bits_at.cu
#: evaluate), by the lines that need them.  Every line of the 576:
#: float32, the quantizer's multiply, subtract, add and floor and its
#: clamp's max and min, 6; int32, the conversion and the running largest
#: value, 2.  A line of the big_values region (2 * big_values lines), int32:
#: the pair's class (two mins and a multiply-add a pair: 1.5), its region
#: (two compares a pair: 1), the three LUT lookups (an address and a load
#: each a pair: 3) and the three candidate sums (an add each a pair: 1.5),
#: 7.  A count1 quad, int32: its index from four values (four mins, three
#: shift-adds), the count1 length's address and load, its sum, and the
#: sign count's popc and sum, 12.
K3_FP32_OPS_LINE, K3_INT32_OPS_LINE = 6, 2
K3_INT32_OPS_PAIR_LINE, K3_INT32_OPS_QUAD = 7, 12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes, ops):
    """The least milliseconds an H100 could take: the larger of the
    bytes over the HBM rate and the operations over the float32 rate;
    returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def call_ms(fn, reps=50):
    """Median milliseconds of one fn() call as a caller sees it on the
    card: CUDA events around the call, host-side overhead included."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, tries=3):
    """Mean device milliseconds per fn() call: the summed time of the
    kernels it runs, read from torch.profiler.  The profiler now and
    then records no device event in a window; it is asked up to `tries`
    times (None if it never recorded device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
        if us > 0:
            return us / 1000.0 / reps
    return None


def kernel_events(fn, names, tries=3):
    """One fn() under torch.profiler's CUDA activity: {name: (events, device
    ms)} of the device events whose name holds each of `names` (asked up to
    `tries` times while the profiler records no device event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        if device:
            break
    return {n: (sum(n in e.name for e in device),
                sum(e.time_range.elapsed_us() for e in device
                    if n in e.name) / 1e3) for n in names}


def kernel_series(fns, names, reps=20, tries=3):
    """One torch.profiler window over `reps` calls of each fn in turn, each
    call launching one kernel whose name holds the fn's entry of `names`:
    the mean device milliseconds of each fn's launches, split by launch
    order.  A window that misses or misplaces an event is asked again, up
    to `tries` times (None if every window did).  One window for many
    timings: the profiler loses more events the more windows a process
    opens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if getattr(e, "device_type", None) == DeviceType.CUDA
                         and any(n in e.name for n in names)),
                        key=lambda e: e.time_range.start)
        blocks = [events[i * reps:(i + 1) * reps] for i in range(len(fns))]
        if len(events) == reps * len(fns) and all(
                name in e.name for name, b in zip(names, blocks) for e in b):
            return [sum(e.time_range.elapsed_us() for e in b) / reps / 1e3
                    for b in blocks]
    return None


def queued_ms(fn, reps=20, tries=4):
    """Mean device milliseconds per fn() call from CUDA events around
    `reps` calls queued behind a sleeping kernel: the card starts the
    first call only once the host has queued the last, so the events read
    the calls back to back on the card (the gaps between kernels
    included), not the host's launch time.  The sleep grows until the
    queue was full before it ended (None if it never was).  The fallback
    where torch.profiler loses events."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(tries):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        full = not a.query()
        b.synchronize()
        if full:
            return a.elapsed_time(b) / reps
        cycles *= 4
    return None


def k1_bound(args, G):
    """K1's bound: ixp, the four per-granule ints and is_short, the LUT
    and count1 lengths read once; bits_tab (G, 3, 32), mx (G, 3), b0raw
    and signs written once; 32 table sums per pair (9,216 adds a
    granule) as operations."""
    from mp3tpu_torch.ops import hist_c1 as k1
    ixp, a1, a2, bv, c1, short, _ = args
    lut, hlen = k1._device_tables(ixp.device)
    out = G * (3 * 32 + 3 + 1 + 1) * 4
    return bound(nbytes(ixp, a1, a2, bv, c1, short, lut, hlen) + out,
                 288 * 32 * G)


def phase_kernel(k1, torch):
    """K1 vs its plain version at the main path's widths; returns
    {G: (max_abs_err, kernel_ms, plain_ms, (bound_ms, bound_by))}."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_hist_c1_card import kernel_args, random_batch
    results = {}
    for G in (512, 4096, 4099):
        args = kernel_args(*random_batch(2024 + G, G), "cuda")
        got = k1.hist_c1(*args)
        torch.cuda.synchronize()
        want = k1.hist_c1_plain(*args)
        err = max(float((a.to(torch.float64) - b.to(torch.float64))
                        .abs().max()) for a, b in zip(got, want))
        for name, a, b in zip(("bits_tab", "mx", "c1_b0raw", "c1_signs"),
                              got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"K1 != plain at G={G} in {name}")
        k_call = call_ms(lambda: k1.hist_c1(*args))
        p_call = call_ms(lambda: k1.hist_c1_plain(*args))
        k_dev = device_ms(lambda: k1.hist_c1(*args))
        p_dev = device_ms(lambda: k1.hist_c1_plain(*args))
        print(f"K1 hist_c1 G={G}: equal to plain (max_abs_err {err}); "
              f"device time per call (torch.profiler): kernel {k_dev} ms, "
              f"plain {p_dev} ms; call time (CUDA events, median of 50): "
              f"kernel {k_call:.4f} ms, plain {p_call:.4f} ms", flush=True)
        if k_dev is None or p_dev is None:
            k_dev, p_dev = k_call, p_call
            print("  (no profiler device time: the JSON reports call times)",
                  flush=True)
        b_ms, b_by = k1_bound(args, G)
        print(f"  bound {b_ms:.6f} ms ({b_by}); kernel at "
              f"{b_ms / k_dev:.1%} of it", flush=True)
        results[G] = (err, k_dev, p_dev, (b_ms, b_by))
    # MPEG-2 LSF (22.05 kHz): its long-block sfb table moves the region
    # addresses
    from mp3tpu_torch.tables import mpeg
    args = kernel_args(*random_batch(22050, 4096), "cuda", mpeg.MPEG2_LSF)
    got = k1.hist_c1(*args)
    torch.cuda.synchronize()
    want = k1.hist_c1_plain(*args)
    for name, a, b in zip(("bits_tab", "mx", "c1_b0raw", "c1_signs"),
                          got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"K1 != plain on the LSF batch in {name}")
    print("K1 hist_c1 G=4096 MPEG-2 LSF 22.05 kHz tables: equal to plain",
          flush=True)
    return results


def bits_at_bound(args):
    """bits_at's bound: xr75p, qss, the two block flags, the per-rate
    table pack, the LUT and count1 lengths read once; 12 int32 rows per
    granule written once; 3 float32 operations a line (scale, offset,
    round) as operations."""
    from mp3tpu_torch.ops import bits_at as K
    xr75p, qss, short, sblk, ST = args
    lut, hlen = K._device_tables(xr75p.device)
    G = xr75p.shape[0]
    return bound(nbytes(xr75p, qss, short, sblk, ST["bits_at_tab"], lut, hlen)
                 + len(K.ROWS) * G * 4, 3 * 576 * G)


def capture_searches(ctx, run, lanes, what):
    """The first stepsize search and the first walk of `lanes` granules
    that run() makes, recorded by wrapping loop.search_stepsize and
    loop.search_walk (whose callers look them up at each call):
    {"stepsize": (args, kwargs), "walk": (args, kwargs)}, tensors cloned."""
    loop = ctx["loop"]
    real = {"stepsize": loop.search_stepsize, "walk": loop.search_walk}
    seen = {}

    def recorder(kind):
        def record(*args, **kwargs):
            if kind not in seen and args[0].shape[0] == lanes:
                seen[kind] = (tuple(a.clone() if hasattr(a, "clone") else a
                                    for a in args),
                              {k: v if v is None else v.clone()
                               for k, v in kwargs.items()})
            return real[kind](*args, **kwargs)
        return record

    loop.search_stepsize = recorder("stepsize")
    loop.search_walk = recorder("walk")
    try:
        run()
    finally:
        loop.search_stepsize = real["stepsize"]
        loop.search_walk = real["walk"]
    for kind in real:
        if kind not in seen:
            fail(f"the {what} made no {lanes}-lane {kind} search")
    return seen


def first_evaluation(captured):
    """bits_at's arguments at the first stepsize a captured stepsize search
    evaluates: the first mid of its bisection (its first bit evaluation,
    the batch this script captured before the searches were one kernel)."""
    import torch
    (xr75p, budget, qanf, short, sblk, ST), kwargs = captured
    from mp3tpu_torch.ops import loop
    lo = torch.clamp(qanf, min=loop.QMIN)
    if kwargs.get("qss_lo") is not None:
        lo = torch.maximum(lo, kwargs["qss_lo"])
    mid = torch.floor((lo + loop.QMAX) * 0.5)
    return xr75p, mid, short, sblk, ST


def path_batch_check(ctx, run, lanes, what):
    """On the first `lanes`-lane stepsize search that run() makes: K3
    against the plain search, and bits_at against bits_at_plain at its
    first stepsize -60, +0 and +8.  Returns (the stepsize search's
    captured (args, kwargs), bits_at's max abs error, K3's, the
    baseline's)."""
    seen = capture_searches(ctx, run, lanes, what)
    s_errs, b_errs, errs = [], [], []
    search_check(ctx, f"{what} stepsize search", "stepsize",
                 *seen["stepsize"], s_errs, b_errs)
    xr75p, qss, short, sblk, ST = first_evaluation(seen["stepsize"])
    for d in (-60.0, 0.0, 8.0):
        bits_at_check(ctx, f"{what} batch at qss{d:+.0f}",
                      (xr75p, qss + d, short, sblk, ST), errs)
    return seen["stepsize"], max(errs), max(s_errs), max(b_errs)


def capture_main_searches(ctx, pcm, cfg):
    """The main path's first stepsize search and walk of each segment
    width: {4096: captured, 512: captured}."""
    return {lanes: capture_searches(
        ctx, lambda: ctx["encode"](pcm, cfg, device="cuda"), lanes,
        "main path") for lanes in (4096, 512)}


def bits_at_check(ctx, label, args, errs):
    """bits_at against bits_at_plain on every output (fails on any
    difference); appends the max abs error to errs; returns the plain
    chain's outputs."""
    torch, loop = ctx["torch"], ctx["loop"]
    from mp3tpu_torch.ops import bits_at as K
    from test_torch_bits_at_card import mismatches
    got = K.bits_at(*args)
    torch.cuda.synchronize()
    want = K.bits_at_plain(*args)
    bad = mismatches(got, want)
    if bad:
        fail(f"bits_at != plain on {label} in {bad}")
    errs.append(max(float((got[k].to(torch.float64)
                           - want[k].to(torch.float64)).abs().max())
                    for k in want))
    over = int((want["ix_max"] > loop.IXMAX).sum())
    short = int(args[2].sum())
    sblk = int((args[3] & ~args[2]).sum())
    print(f"bits_at {label}: every output equal to plain (G="
          f"{args[0].shape[0]}: {short} short, {sblk} start/stop, "
          f"{over} past IXMAX)", flush=True)
    return want


def bits_at_timed(ctx, label, args):
    """Kernel device and call time, the plain chain's device time, and
    K1's device time on the same quantized batch."""
    k1, loop = ctx["k1"], ctx["loop"]
    from mp3tpu_torch.ops import bits_at as K
    xr75p, qss, short, sblk, ST = args
    ixp = loop.quantize_pow75(xr75p, qss)
    count1, bv = loop.calc_runlen(ixp, short)
    _, _, a1, a2 = loop.subdivide(bv, short, sblk, ST)
    k1_args = (ixp, a1, a2, bv, count1, short, ST["r0_pairs_short"])
    k_dev = device_ms(lambda: K.bits_at(*args))
    k_call = call_ms(lambda: K.bits_at(*args))
    p_dev = device_ms(lambda: K.bits_at_plain(*args))
    k1_dev = device_ms(lambda: k1.hist_c1(*k1_args))
    if k_dev is None or p_dev is None:
        k_dev = k_call
        p_dev = call_ms(lambda: K.bits_at_plain(*args))
        print("  (no profiler device time: kernel and plain chain "
              "report call times)", flush=True)
    b_ms, b_by = bits_at_bound(args)
    print(f"bits_at {label} timed: device time per call (torch.profiler, "
          f"mean of 20): kernel {k_dev} ms, plain chain {p_dev} ms, K1 "
          f"alone on the same quantized batch {k1_dev} ms; kernel call "
          f"time (CUDA events, median of 50) {k_call:.4f} ms; bound "
          f"{b_ms:.6f} ms ({b_by}), kernel at {b_ms / k_dev:.1%} of it",
          flush=True)
    return k_dev, p_dev, k1_dev, b_ms, b_by


def phase_bits_at(ctx, main_args):
    """Phase 3b: bits_at against bits_at_plain on the card; returns the
    JSON fields measured on the main path's own 4096-lane batch."""
    loop, mpeg = ctx["loop"], ctx["mpeg"]
    from test_torch_bits_at_card import kernel_args, random_batch
    errs = []

    def check(label, args):
        return bits_at_check(ctx, label, args, errs)

    # the main path's widths, then wider batches (a corpus batches clips
    # as extra lanes): one granule a warp at G = 4096 fills one wave
    for G in (512, 4096, 4099, 16384, 65536):
        args = kernel_args(*random_batch(3030 + G, G), "cuda")
        check(f"random G={G}", args)
        bits_at_timed(ctx, f"random G={G}", args)
    lsf = kernel_args(*random_batch(22050, 4096), "cuda", mpeg.MPEG2_LSF)
    check("random G=4096, MPEG-2 LSF 22.05 kHz tables", lsf)
    xr75, qss, is_short, wsf = random_batch(7, 4096)
    xr75[:, 0] = 1e6
    import numpy as np
    over = kernel_args(xr75, np.full_like(qss, -40.0), is_short, wsf, "cuda")
    if not bool((check("G=4096 all past IXMAX", over)["bits"] == 1e9).all()):
        fail("bits_at: a granule past IXMAX did not get 1e9 bits")

    xr75p, qss, short, sblk, ST = main_args
    n_over = 0
    for d in (-60.0, -8.0, -4.0, 0.0, 4.0, 8.0):
        want = check(f"main path's batch at qss{d:+.0f}",
                     (xr75p, qss + d, short, sblk, ST))
        n_over += int((want["ix_max"] > loop.IXMAX).sum())
    if n_over == 0:
        fail("no stepsize of the main path's batch went past IXMAX")
    k_dev, p_dev, k1_dev, b_ms, b_by = bits_at_timed(ctx, "main path's batch",
                                                     main_args)
    return dict(max_abs_err=max(errs), ms=k_dev, plain_ms=p_dev,
                k1_ms=k1_dev, bound_ms=b_ms, bound_by=b_by)


def search_fns(kind):
    """(K3's wrapper, the lockstep plain search, K3's first design kept
    as the baseline) of a search kind."""
    from mp3tpu_torch.ops import loop, search
    if kind == "stepsize":
        return (search.search_stepsize, loop.search_stepsize_plain,
                search.baseline_stepsize)
    return search.search_walk, loop.search_walk_plain, search.baseline_walk


def search_err(got, want):
    """The largest absolute difference of two search results over qss,
    bits and the plain search's count rows."""
    import torch
    pairs = [(got[0], want[0]), (got[1], want[1])] + [
        (got[2][k], v) for k, v in want[2].items()]
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def search_check(ctx, label, kind, args, kwargs, errs, base_errs):
    """K3 at the width its launch picks and at each width of WIDTHS, and
    the baseline, against the lockstep plain search (on bits_at):
    torch.equal on qss, bits, every count row and the evaluation counts,
    and status 0 everywhere; appends K3's max abs error (at the picked
    width) to errs and the baseline's to base_errs; returns K3's result at
    the picked width."""
    import torch
    from mp3tpu_torch.ops import search
    from test_torch_search_card import search_mismatches
    kernel, plain, baseline = search_fns(kind)
    G = args[0].shape[0]
    got = {"the picked width": kernel(*args, **kwargs)}
    for w in WIDTHS:
        got[f"width {w}"] = kernel(*args, **kwargs, width=w)
    got["the baseline"] = baseline(*args, **kwargs)
    torch.cuda.synchronize()
    want = plain(*args, **kwargs)
    for how, res in got.items():
        bad = search_mismatches(res, want)
        if bad:
            fail(f"K3 at {how} != the plain {kind} search on {label} in "
                 f"{bad}")
        if bool(res[2]["status"].any()):
            fail(f"K3 at {how} on {label}: a stepsize missed the istep75 "
                 f"table")
    res = got["the picked width"]
    errs.append(search_err(res, want))
    base_errs.append(search_err(got["the baseline"], want))
    evals = res[2]["evals"]
    cap = 42 if kind == "walk" else 53
    runs = {w: int(got[f"width {w}"][2]["runs"].sum()) for w in WIDTHS}
    pick = search.plan(G)["width"] if G else 1
    print(f"K3 {kind} search {label}: equal to the plain search on every "
          f"output, status 0, at the picked width {pick}, at widths "
          f"{', '.join(map(str, WIDTHS))} and in the baseline (G={G}: "
          f"evaluations per granule {int(evals.min())}-{int(evals.max())}, "
          f"{int(evals.sum())} in all, {int((evals == cap).sum())} at the "
          f"40-step cap; {int((res[1] == 1e9).sum())} left past IXMAX); "
          f"evaluations run by width {runs}", flush=True)
    return res


def serial_work(kind, args, kwargs, n_bisect=8, max_steps=40):
    """K3's schedule at width 1 (csrc/bits_at.cu search_kernel with one warp
    a granule; tests/test_torch_search_card.py model_granule on the CPU)
    replayed over the batch, one bits_at launch a pass: the stepsizes whose
    outcome the plain search reads, each evaluated once.  Returns (G,)
    tensors: qss, runs (the evaluations), pair_lines (2 * big_values summed
    over them: the lines of their big_values regions) and quads (count1
    summed over them)."""
    import torch
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import loop
    xr75p, budget, start, short, sblk, ST = args
    G, dev = xr75p.shape[0], xr75p.device
    BISECT, WALK, DOWN, DONE = 0, 1, 2, 3

    def full(v, dtype=torch.float32):
        return torch.full((G,), v, dtype=dtype, device=dev)

    qss = start.clone()
    floor_q, lo, hi, below = (full(loop.QMIN), full(loop.QMIN),
                              full(loop.QMAX), full(0.0))
    lo_known, hi_known, below_known = (full(False, torch.bool)
                                       for _ in range(3))
    left, steps, first, down, runs, pair_lines, quads = (
        full(0, torch.int64) for _ in range(7))
    phase = full(WALK, torch.int64)
    if kind == "stepsize":
        floor_q = torch.maximum(qss, floor_q)        # NaN as nan_max keeps it
        lo = floor_q
        if kwargs.get("qss_lo") is not None:
            lo = torch.maximum(floor_q, kwargs["qss_lo"])
        left = full(n_bisect, torch.int64)
        phase = full(BISECT, torch.int64)
    for _ in range(n_bisect + max_steps + 8):
        # a bisection with no step left hands hi on without an evaluation;
        # a down rung known not to fit ends the search
        end = (phase == BISECT) & (left == 0)
        qss = torch.where(end, hi, qss)
        phase = torch.where(end, torch.where(hi_known, DOWN, WALK), phase)
        mid = torch.floor((lo + hi) * 0.5)
        q_down = qss - 1.0
        known_miss = ~(q_down >= floor_q) | (below_known & (q_down == below)) \
            | (lo_known & (q_down == lo))
        phase = torch.where((phase == DOWN) & known_miss, DONE, phase)
        if not bool((phase != DONE).any()):
            break
        bis, walk_, dn = phase == BISECT, phase == WALK, phase == DOWN
        mid_lo, mid_hi = lo_known & (mid == lo), hi_known & (mid == hi)
        q = torch.where(bis, mid, torch.where(walk_, qss + first, q_down))
        active = walk_ | dn | (bis & ~mid_lo & ~mid_hi)
        c = K.bits_at(xr75p, torch.where(active, q, 0.0), short, sblk, ST)
        fits = c["bits"] <= budget
        runs += active
        pair_lines += torch.where(active, 2 * c["big_values"], 0)
        quads += torch.where(active, c["count1"], 0)
        # the bisection: a mid equal to a known bound takes its outcome
        ok = torch.where(mid_lo, False, torch.where(mid_hi, True, fits))
        hi = torch.where(bis & ok, mid, hi)
        lo = torch.where(bis & ~ok, mid, lo)
        hi_known |= bis & ok
        lo_known |= bis & ~ok
        left = left - bis.long()
        # the walk: one rung up from the second on, until it fits or caps
        up = walk_ & (first == 1)
        below = torch.where(up, qss, below)
        below_known |= up
        qss = torch.where(walk_, q, qss)
        steps = steps + torch.where(walk_, first, 0)
        first = torch.where(walk_, 1, first)
        w_end = walk_ & (fits | (steps >= max_steps))
        # the down steps: keep a rung that fits, end at the first miss
        qss = torch.where(dn & fits, q_down, qss)
        down = down + (dn & fits).long()
        d_end = dn & (~fits | (down == 3))
        phase = torch.where(w_end, DONE if kind == "walk" else DOWN, phase)
        phase = torch.where(d_end, DONE, phase)
    else:
        fail(f"the width-1 replay of a {kind} search did not end")
    return dict(qss=qss, runs=runs, pair_lines=pair_lines, quads=quads)


def search_bound(args, kwargs, work):
    """K3's bound, the larger of two times.  Bytes: xr75p, the per-granule
    scalars, the rate tables, the LUT, the count1 lengths and the istep75
    table read once, 16 int32 rows a granule written once, over the HBM
    rate.  Operations: the evaluations the search needs (`work`, from
    serial_work: once each stepsize whose outcome the plain search reads),
    K3_FP32_OPS_LINE float32 operations a line over the float32 rate and
    the int32 operations that each evaluation's lines need
    (K3_INT32_OPS_LINE on all 576, K3_INT32_OPS_PAIR_LINE on the lines of
    its big_values region, K3_INT32_OPS_QUAD a count1 quad) over the
    int32 rate, the two pipes side by side.  Returns (ms, "bytes" or
    "operations", the bytes' ms, the operations' ms)."""
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import search
    xr75p, budget, start, short, sblk, ST = args
    lut, hlen = K._device_tables(xr75p.device)
    extra = [v for v in kwargs.values() if v is not None]
    G = xr75p.shape[0]
    rows = len(K.ROWS) + len(search.EXTRA_ROWS)
    b_ms = 1e3 * (nbytes(xr75p, budget, start, short, sblk, ST["bits_at_tab"],
                         lut, hlen, search._istep_table(xr75p.device), *extra)
                  + rows * G * 4) / HBM_BYTES_PER_S
    lines = 576 * int(work["runs"].sum())
    int32_ops = (K3_INT32_OPS_LINE * lines
                 + K3_INT32_OPS_PAIR_LINE * int(work["pair_lines"].sum())
                 + K3_INT32_OPS_QUAD * int(work["quads"].sum()))
    o_ms = 1e3 * max(K3_FP32_OPS_LINE * lines / FP32_OPS_PER_S,
                     int32_ops / INT32_OPS_PER_S)
    if b_ms >= o_ms:
        return b_ms, "bytes", b_ms, o_ms
    return o_ms, "operations", b_ms, o_ms


def search_timed(ctx, label, kind, args, kwargs, plain_too=False):
    """K3's first design (the baseline) and K3 at the width its launch picks,
    in turns (baseline, K3, K3, baseline; device time per call from
    torch.profiler, a mean of 20 a turn); K3 at each width of WIDTHS; both
    call times; the evaluations the plain schedule counts against those
    K3 runs; the bound and each design's share of it.  With plain_too also
    the lockstep plain search on bits_at (the lockstep path): its device time,
    call time and bits_at launches."""
    K = ctx["K"]
    from mp3tpu_torch.ops import search
    kernel, plain, baseline = search_fns(kind)
    G = args[0].shape[0]
    pick = search.plan(G)["width"]

    def k3(width=None):
        return lambda: kernel(*args, **kwargs, width=width)

    def base():
        return baseline(*args, **kwargs)

    k3_name, b_name = "search_kernel(", "search_baseline("
    fns = [base, k3(), k3(), base] + [k3(w) for w in WIDTHS]
    ms = kernel_series(fns, [b_name, k3_name, k3_name, b_name]
                       + [k3_name] * len(WIDTHS))
    # the repeated launches left K3's granule counter at zero and gave the
    # checked results
    import torch
    from test_torch_search_card import search_mismatches
    again = kernel(*args, **kwargs)
    stream = torch.cuda.current_stream().cuda_stream
    if search_mismatches(again, plain(*args, **kwargs)) or bool(
            search._counter(args[0].device, stream).any()):
        fail(f"K3 on {label}: a timed launch left other results or a "
             f"granule counter off zero")
    k_call = call_ms(k3())
    b_call = call_ms(base)
    note = ""
    if ms is None:
        ms = [queued_ms(fn) for fn in fns]
        note = (" (torch.profiler lost events: CUDA events around 20 calls "
                "queued behind a sleep)")
        if None in ms[:4]:
            ms = [b_call, k_call, k_call, b_call] + [None] * len(WIDTHS)
            note = " (no device time: call times)"
    turns = {"baseline": [ms[0], ms[3]], "k3": [ms[1], ms[2]]}
    by_width = dict(zip(WIDTHS, ms[4:]))
    k_dev = statistics.mean(turns["k3"])
    b_dev = statistics.mean(turns["baseline"])
    evals = kernel(*args, **kwargs)[2]["evals"]
    runs = {w: kernel(*args, **kwargs, width=w) for w in sorted({1, pick})}
    work = serial_work(kind, args, kwargs)
    one = runs[1]
    if not (bool(((work["qss"] == one[0])
                  | (work["qss"].isnan() & one[0].isnan())).all())
            and torch.equal(work["runs"].int(), one[2]["runs"])):
        fail(f"K3 on {label}: the width-1 replay of its schedule ran other "
             f"stepsizes than K3 at width 1")
    runs = {w: r[2]["runs"] for w, r in runs.items()}
    b_ms, b_by, bytes_ms, ops_ms = search_bound(args, kwargs, work)
    res = dict(ms=k_dev, call_ms=k_call, baseline_ms=b_dev,
               baseline_call_ms=b_call, turns=turns, by_width=by_width,
               width=pick, evals=int(evals.sum()),
               runs={w: int(r.sum()) for w, r in runs.items()},
               bound_ms=b_ms, bound_by=b_by, bytes_ms=bytes_ms,
               ops_ms=ops_ms, work={k: int(work[k].sum()) for k in
                                    ("runs", "pair_lines", "quads")})
    line = (f"K3 {kind} search {label} timed: G={G}, width {pick} picked; "
            f"device time per call (torch.profiler, the kernels' own events, "
            f"mean of 20 a turn; turns baseline, K3, K3, baseline, then K3 by "
            f"width, in one window){note}: K3 "
            f"{' / '.join(str(t) for t in turns['k3'])} ms, the baseline "
            f"{' / '.join(str(t) for t in turns['baseline'])} ms, "
            f"{b_dev / k_dev:.2f}x; K3 by width (ms): {by_width}; call "
            f"time (CUDA events, median of 50): K3 {k_call:.4f} ms, baseline "
            f"{b_call:.4f} ms; evaluations: {res['evals']} as the plain "
            f"schedule counts them, run {res['runs']} by width; bound "
            f"{b_ms:.6f} ms ({b_by}; bytes {bytes_ms:.6f} ms, operations "
            f"{ops_ms:.6f} ms over the width-1 schedule's {res['work']}): K3 "
            f"at {b_ms / k_dev:.1%} of it, the baseline "
            f"at {b_ms / b_dev:.1%}")
    if plain_too:
        p_dev = device_ms(lambda: plain(*args, **kwargs))
        p_call = call_ms(lambda: plain(*args, **kwargs), reps=20)
        before = K.bits_at.launches
        plain(*args, **kwargs)
        res.update(plain_ms=p_dev if p_dev is not None else p_call,
                   plain_call_ms=p_call,
                   plain_launches=K.bits_at.launches - before)
        line += (f"; the plain search on bits_at: device {p_dev} ms, call "
                 f"{p_call:.4f} ms ({res['plain_launches']} bits_at "
                 f"launches)")
    print(line, flush=True)
    return res


def phase_search(ctx, main_searches):
    """Phase 3c: K3 and the baseline against the lockstep plain searches
    on the card, and timed in turns; returns the fields measured on the
    main path's own first 4096-lane stepsize search, and the main path's
    four captured searches' measurements under "main"."""
    from test_torch_search_card import case_args, search_case
    errs, base_errs = [], []
    # the main path's searches first: the profiler's windows after the
    # widest batches have lost events
    main = {}
    for lanes in (4096, 512):
        for kind in ("walk", "stepsize"):
            args, kwargs = main_searches[lanes][kind]
            label = f"main path's first {lanes}-lane {kind} search"
            search_check(ctx, label, kind, args, kwargs, errs, base_errs)
            main[(lanes, kind)] = search_timed(ctx, label, kind, args,
                                               kwargs, plain_too=True)
    for G in (512, 4096, 4099, 16384, 65536):
        for name in ("stepsize", "walk"):
            kind, args, kwargs = case_args(search_case(name, G, 6060 + G),
                                           "cuda")
            search_check(ctx, f"random G={G}", kind, args, kwargs, errs,
                         base_errs)
            search_timed(ctx, f"random G={G}", kind, args, kwargs,
                         plain_too=name == "stepsize")
    for name in ("stepsize_lsf", "walk_lsf", "stepsize_qss_lo", "walk_cap",
                 "stepsize_cap"):
        kind, args, kwargs = case_args(search_case(name, 4096, 22050),
                                       "cuda")
        got = search_check(ctx, f"{name} G=4096", kind, args, kwargs, errs,
                           base_errs)
        cap = {"walk_cap": 42, "stepsize_cap": 53}.get(name)
        if cap and not int((got[2]["evals"] == cap).sum()):
            fail(f"the {name} case put no granule at the 40-step cap")
        search_timed(ctx, f"{name} G=4096", kind, args, kwargs)
    return dict(main[(4096, "stepsize")], max_abs_err=max(errs),
                baseline_max_abs_err=max(base_errs), main=main)


def check_grid(out, kbps, rate, nsamples):
    fsize = (144000 * kbps) // rate
    nframes = -(-nsamples // 1152)
    if len(out) != nframes * fsize + 1:
        fail(f"stream length {len(out)} != {nframes} frames x {fsize} + 1")
    for f in range(nframes):
        if out[f * fsize] != 0xFF or (out[f * fsize + 1] & 0xF0) != 0xF0:
            fail(f"frame {f}: no sync word at byte {f * fsize}")
    return fsize, nframes


def phase_quality():
    """Phase 4: the quality tool on the card, every fixture."""
    from mp3tpu_torch.tools import quality
    report = quality.run([c[0] for c in quality.CASES], "cuda")
    worst = None
    for name, fx in report["fixtures"].items():
        if not fx["valid_cbr_grid"]:
            fail(f"{name}: the stream is off the CBR frame grid")
        if not fx["pass"]:
            fail(f"{name}: decoded rate or SNR below the reference bar: "
                 f"{fx['channels']}")
        for c, ch in enumerate(fx["channels"]):
            if worst is None or ch["margin_db"] < worst[0]:
                worst = (ch["margin_db"], name, c, ch["snr_db"])
    print(f"quality: {len(report['fixtures'])} fixtures on the frame grid "
          f"and at or above their ref_snr.json bars; worst margin "
          f"{worst[0]:+.2f} dB ({worst[1]} ch{worst[2]}: {worst[3]:.2f} dB)",
          flush=True)
    mpg = {n: fx["mpg123_snr_db"] for n, fx in report["fixtures"].items()}
    if all(v is None for v in mpg.values()):
        print("quality: libmpg123 is absent: no cross-decode", flush=True)
    else:
        print(f"quality: libmpg123 best-lag SNR by fixture (dB): {mpg}",
              flush=True)


def first_seconds_snr(np, out, pcm, fsize, seconds, decode_mp3, snr_db,
                      rate=44100, spf=1152):
    nf = -(-int(seconds * rate) // spf)
    dec, _ = decode_mp3(out[:nf * fsize])
    return [float(snr_db(pcm[:nf * spf, c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[1])]


def lsf_grid(out, rate, kbps):
    """tests/test_lsf.py's check: MPEG-2 version bit, every interior frame
    on the CBR grid (an LSF stream's tail is cut mid-frame at flush)."""
    fsize = 72000 * kbps // rate
    if out[0] != 0xFF or (out[1] & 0xF0) != 0xF0:
        fail(f"LSF {rate} Hz: no sync word at byte 0")
    if (out[1] >> 3) & 1:
        fail(f"LSF {rate} Hz: version bit is not MPEG-2")
    nfull = (len(out) - 1) // fsize
    if nfull < 5:
        fail(f"LSF {rate} Hz: only {nfull} whole frames")
    for k in range(nfull - 1):
        if out[k * fsize] != 0xFF or (out[k * fsize + 1] & 0xF0) != 0xF0:
            fail(f"LSF {rate} Hz: frame {k} off the grid")
    return fsize


def reset_counts(ctx):
    ctx["S"].launches = 0
    ctx["S"].baseline_launches = 0
    ctx["K"].bits_at.launches = 0
    ctx["k1"].hist_c1.launches = 0
    ctx["loop"].any_on_host.syncs = 0
    ctx["torch"].cuda.synchronize()


def launch_counts(ctx):
    """{kernel: launches, "syncs": loop-exit host syncs} since
    reset_counts."""
    return {"search": ctx["S"].launches, "bits_at": ctx["K"].bits_at.launches,
            "hist_c1": ctx["k1"].hist_c1.launches,
            "baseline": ctx["S"].baseline_launches,
            "syncs": ctx["loop"].any_on_host.syncs}


def read_counts(ctx, path):
    """launch_counts; fails unless the path launched K3, and its rate loop
    launched bits_at and the baseline no time."""
    counts = launch_counts(ctx)
    if counts["search"] <= 0:
        fail(f"the {path} launched K3 no time")
    for kernel in ("bits_at", "baseline"):
        if counts[kernel]:
            fail(f"the {path} launched {kernel} {counts[kernel]} times")
    return counts


def phase_lsf(ctx):
    """Phase 6: MPEG-2 LSF on the card; returns the launches on the 60 s
    clip."""
    np, torch = ctx["np"], ctx["torch"]
    EncoderConfig, mpeg = ctx["EncoderConfig"], ctx["mpeg"]
    encode, decode_mp3, snr_db = (ctx["encode"], ctx["decode_mp3"],
                                  ctx["snr_db"])
    for rate, kbps in ((22050, 64), (24000, 64), (16000, 48)):
        t = np.arange(int(0.5 * rate)) / rate
        rng = np.random.RandomState(5)
        x = 0.25 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.randn(len(t))
        pcm = np.clip(x * 20000, -32768, 32767).astype(np.int16)
        cfg = EncoderConfig(layer=3, mode=mpeg.MODE_MONO, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        out = encode(pcm, cfg, device="cuda")
        lsf_grid(out, rate, kbps)
        dec, drate = decode_mp3(out)
        snr = float(snr_db(pcm.astype(np.float64), dec[:, 0]))
        if drate != rate or not snr > 25.0:
            fail(f"LSF {rate} Hz {kbps} kbps: rate {drate}, SNR {snr:.2f} dB")
        print(f"LSF {rate} Hz {kbps} kbps mono 0.5 s: MPEG-2 grid, decoded "
              f"SNR {snr:.2f} dB (> 25)", flush=True)

    rate, kbps = 24000, 64
    pcm = ctx["make_signal"](CLIP_SECONDS, rate)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=kbps,
                        sample_rate_hz=rate)
    reset_counts(ctx)
    t0 = time.perf_counter()
    out = encode(pcm, cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts(ctx, "LSF path")
    fsize = lsf_grid(out, rate, kbps)
    print(f"LSF 60 s stereo 24 kHz 64 kbps: {len(out)} bytes, interior "
          f"frames on the {fsize}-byte grid, {wall:.3f} s (first run): "
          f"{CLIP_SECONDS / wall:.2f}x real time; launches {launches}",
          flush=True)
    t0 = time.perf_counter()
    encode(pcm, cfg, device="cuda")
    wall = time.perf_counter() - t0
    print(f"LSF 60 s stereo 24 kHz 64 kbps, second run: {wall:.3f} s, "
          f"{CLIP_SECONDS / wall:.2f}x real time", flush=True)
    short = pcm[:int(10.0 * rate)]
    out_cpu = encode(short, cfg, device="cpu")
    args = (np, decode_mp3, snr_db, rate, 576)
    snr_gpu = first_seconds_snr(args[0], out, pcm, fsize, 10.0, *args[1:])
    snr_cpu = first_seconds_snr(args[0], out_cpu, short, fsize, 10.0,
                                *args[1:])
    print(f"LSF first 10 s decoded SNR: cuda {snr_gpu} dB, cpu path "
          f"{snr_cpu} dB", flush=True)
    ctx["streams"]["LSF 60 s stereo 24 kHz 64 kbps"] = (
        out, pcm, rate, fsize, 576, decode_mp3)
    for g, c in zip(snr_gpu, snr_cpu):
        if not np.isfinite(g) or g < c - 1.0:
            fail(f"LSF first-10 s SNR {g:.2f} dB is more than 1 dB below "
                 f"the CPU path's {c:.2f} dB")
    return launches


def phase_stream(ctx, pcm, cfg_of):
    """Phase 7: StreamEncoder on the card against the one-shot encode;
    returns the launches on the timed stream."""
    from mp3tpu_torch.encoder import StreamEncoder
    rate = 44100
    one = ctx["encode"](pcm, cfg_of(), device="cuda", chunk=1024)

    def run(enc, lo, hi):
        out = []
        for s in range(lo, hi, rate):
            out.append(enc.feed(pcm[s:min(s + rate, hi)]))
        return b"".join(out)

    reset_counts(ctx)
    t0 = time.perf_counter()
    enc = StreamEncoder(cfg_of(), "cuda", window=1024)
    streamed = run(enc, 0, len(pcm)) + enc.finish()
    wall = time.perf_counter() - t0
    launches = read_counts(ctx, "streaming path")
    if streamed != one:
        fail(f"stream ({len(streamed)} bytes) != one-shot at chunk 1024 "
             f"({len(one)} bytes)")
    print(f"stream: 60 s stereo 128 kbps in 1 s pieces, window 1024: "
          f"{wall:.3f} s, {CLIP_SECONDS / wall:.2f}x real time; equal to "
          f"the one-shot encode at chunk 1024 ({len(one)} bytes); "
          f"launches {launches}", flush=True)

    cut = 30 * rate
    enc1 = StreamEncoder(cfg_of(), "cuda", window=1024)
    part1 = run(enc1, 0, cut)
    blob = pickle.dumps(enc1.checkpoint())
    del enc1
    enc2 = StreamEncoder.resume(cfg_of(), pickle.loads(blob), "cuda",
                                window=1024)
    part2 = run(enc2, cut, len(pcm)) + enc2.finish()
    if part1 + part2 != one:
        fail("checkpoint at 30 s + resume != the uninterrupted stream")
    print(f"stream: checkpoint at 30 s ({len(blob)} bytes pickled) and "
          f"resume in a fresh encoder give the same bytes", flush=True)
    return launches


L12_FIXTURES = [
    ("l2_sine_st_192", 2, "s", 192, 44100),
    ("l2_noise_j_128", 2, "j", 128, 44100),
    ("l2_sweep_mono_96", 2, "m", 96, 44100),
    ("l2_trans_st_256_48k", 2, "s", 256, 48000),
    ("l1_sine_st_384", 1, "s", 384, 44100),
    ("l1_sweep_j_256", 1, "j", 256, 44100),
]
L12_DELAY = {1: 545, 2: 481}


def l12_snr(np, orig, deco, d):
    n = min(len(orig) - d, len(deco) - d)
    o = orig[:n].astype(np.float64)
    err = o - deco[d:d + n] * 32768.0
    return 10 * np.log10((o ** 2).sum() / max((err ** 2).sum(), 1e-30))


def phase_layer12(ctx):
    """Phase 8: Layers I/II on the card."""
    np, torch, EncoderConfig, mpeg = (ctx["np"], ctx["torch"],
                                      ctx["EncoderConfig"], ctx["mpeg"])
    from mp3tpu_torch.decoder import layer12 as dec12
    from mp3tpu_torch.encoder import encode_layer12_fast
    modes = {"s": mpeg.MODE_STEREO, "j": mpeg.MODE_JOINT,
             "m": mpeg.MODE_MONO}
    golden = os.path.join(ROOT, "tests", "golden")
    worst = None
    for name, layer, mode, kbps, rate in L12_FIXTURES:
        pcm, _ = ctx["read_wav"](os.path.join(golden, f"{name}.wav"))
        cfg = EncoderConfig(layer=layer, mode=modes[mode],
                            bitrate_kbps=kbps, sample_rate_hz=rate)
        out = encode_layer12_fast(pcm, cfg, "cuda")
        with open(os.path.join(golden, f"{name}.ref.mp{layer}"), "rb") as f:
            ref = f.read()
        if len(out) != len(ref) or out[:3] != ref[:3]:
            fail(f"{name}: length {len(out)} vs {len(ref)} or header "
                 f"{out[:3].hex()} vs {ref[:3].hex()}")
        dec_o, _ = dec12.decode(out)
        dec_r, _ = dec12.decode(ref)
        for c in range(pcm.shape[1]):
            s_o = l12_snr(np, pcm[:, c], dec_o[:, c], L12_DELAY[layer])
            s_r = l12_snr(np, pcm[:, c], dec_r[:, c], L12_DELAY[layer])
            if not s_o >= s_r - 0.5:
                fail(f"{name} ch{c}: SNR {s_o:.2f} dB vs reference "
                     f"{s_r:.2f} dB")
            if worst is None or s_o - s_r < worst[0]:
                worst = (s_o - s_r, name, c)
    pcm, rate = ctx["read_wav"](os.path.join(golden,
                                             "l2_noise_st_192_crc.wav"))
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=rate, error_protection=True)
    dec, _ = dec12.decode(encode_layer12_fast(pcm, cfg, "cuda"))
    if len(dec) < len(pcm) - 1152 or \
            not l12_snr(np, pcm[:, 0], dec[:, 0], L12_DELAY[2]) > 0.0:
        fail("Layer II CRC fixture does not decode")
    print(f"Layers I/II: 6 fixtures at the reference streams' length and "
          f"header, decoded SNR within 0.5 dB (worst {worst[0]:+.4f} dB, "
          f"{worst[1]} ch{worst[2]}); CRC fixture decodes", flush=True)

    pcm = ctx["make_signal"](CLIP_SECONDS, 44100)
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=44100)
    out = encode_layer12_fast(pcm, cfg, "cuda")             # warm-up
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = encode_layer12_fast(pcm, cfg, "cuda")
        times.append(time.perf_counter() - t0)
        if out_t != out:
            fail("Layer II: two encodes of one clip differ")
    fsize = int(1152 / 44.1 * 192 / 8)
    nframes = -(-len(pcm) // 1152)
    if len(out) != nframes * fsize + 1:
        fail(f"Layer II stream length {len(out)} != {nframes} x {fsize} + 1")
    for f in range(nframes):
        if out[f * fsize] != 0xFF or (out[f * fsize + 1] & 0xF0) != 0xF0:
            fail(f"Layer II frame {f} off the grid")
    wall = statistics.median(times)
    short = pcm[:int(10.0 * 44100)]
    out_cpu = encode_layer12_fast(short, cfg, "cpu")
    nf = -(-len(short) // 1152)
    dec_g, _ = dec12.decode(out[:nf * fsize])
    dec_c, _ = dec12.decode(out_cpu[:nf * fsize])
    snr_g = [l12_snr(np, short[:, c], dec_g[:, c], L12_DELAY[2])
             for c in range(2)]
    snr_c = [l12_snr(np, short[:, c], dec_c[:, c], L12_DELAY[2])
             for c in range(2)]
    print(f"Layer II 60 s stereo 192 kbps: {wall:.3f} s median of "
          f"{TIMED_RUNS} ({', '.join(f'{t:.3f}' for t in times)} s): "
          f"{CLIP_SECONDS / wall:.2f}x real time; frame grid ok; first 10 s "
          f"SNR cuda {snr_g} dB, cpu path {snr_c} dB", flush=True)
    for g, c in zip(snr_g, snr_c):
        if not np.isfinite(g) or g < c - 0.5:
            fail(f"Layer II first-10 s SNR {g:.2f} dB is more than 0.5 dB "
                 f"below the CPU path's {c:.2f} dB")
    ctx["streams"]["Layer II 60 s stereo 192 kbps"] = (
        out, pcm, 44100, fsize, 1152, dec12.decode)


def phase_cli(ctx, pcm, cfg_of):
    """Phase 9: python -m mp3tpu_torch writes the library's bytes."""
    np, EncoderConfig, mpeg = ctx["np"], ctx["EncoderConfig"], ctx["mpeg"]
    from mp3tpu_torch.encoder import encode_layer3_stream, encode_layer12_fast
    from mp3tpu_torch.runtime.wav import write_wav
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    pcm = pcm[:int(10.0 * 44100)]
    wav = os.path.join(work, "in.wav")
    write_wav(wav, pcm, 44100)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(args, stdin=None):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "mp3tpu_torch",
                              "--device", "cuda"] + args, input=stdin,
                             cwd=ROOT, env=env, capture_output=True,
                             timeout=300)
        if res.returncode != 0:
            fail(f"mp3tpu_torch {' '.join(args)}: rc {res.returncode}\n"
                 f"{res.stderr.decode(errors='replace')[-2000:]}")
        return time.perf_counter() - t0

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    out1 = os.path.join(work, "out.mp3")
    t1 = cli(["-b", "128", wav, out1])
    if read(out1) != ctx["encode"](pcm, cfg_of(), device="cuda"):
        fail("CLI file encode != encode_layer3_fast(..., 'cuda')")
    out2 = os.path.join(work, "out2.mp3")
    raw = pcm.astype(">i2").tobytes()
    t2 = cli(["-b", "128", "-s", "44.1", "-", out2], stdin=raw)
    lib = b"".join(encode_layer3_stream([pcm], cfg_of(), "cuda"))
    if read(out2) != lib:
        fail("CLI stdin stream != encode_layer3_stream(..., 'cuda')")
    out3 = os.path.join(work, "out3.mp2")
    t3 = cli(["-l", "2", "-b", "192", wav, out3])
    cfg = EncoderConfig(layer=2, mode=mpeg.MODE_STEREO, bitrate_kbps=192,
                        sample_rate_hz=44100)
    if read(out3) != encode_layer12_fast(pcm, cfg, "cuda"):
        fail("CLI -l 2 encode != encode_layer12_fast(..., 'cuda')")
    print(f"CLI: python -m mp3tpu_torch --device cuda equals the library "
          f"on a 10 s WAV ({t1:.2f} s), raw stdin stream ({t2:.2f} s) and "
          f"-l 2 ({t3:.2f} s), process start included", flush=True)


CORPUS_CLIPS = 32
CORPUS_SECONDS = 10.0
CORPUS_BATCHES = (1, 2, 4, 8, 16)


def group_split(ctx, group, kw):
    """One corpus group's wall split into the per-lane analysis
    (Layer3SegmentEncoder._analyze_chunk), the rate loops (loop.outer_loop)
    and the rest, each timed between synchronizes; and the device kernels
    and copies of each stage, counted by torch.profiler over a replay of
    that stage's calls, and of the whole group."""
    torch, loop = ctx["torch"], ctx["loop"]
    from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder as Enc
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    real = {"analysis": Enc._analyze_chunk, "rate loop": loop.outer_loop}
    secs = dict.fromkeys(real, 0.0)
    calls = {k: [] for k in real}

    def timed(key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[key](*args, **kwargs)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            calls[key].append((args, kwargs))
            return out
        return run

    def encode():
        return encode_corpus_batched(group, kw, "cuda", batch=len(group))

    Enc._analyze_chunk, loop.outer_loop = timed("analysis"), timed("rate loop")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        wall = time.perf_counter() - t0
    finally:
        Enc._analyze_chunk = real["analysis"]
        loop.outer_loop = real["rate loop"]
    kernels = {}
    for key, fn in real.items():
        kernels[key] = profile_once(
            lambda: [fn(*a, **k) for a, k in calls[key]])[0]
    kernels["whole group"] = profile_once(encode)[0]
    print(f"corpus group of {len(group)} clips ({2 * len(group)} lanes): "
          f"wall {wall:.4f} s with a synchronize around each stage call; "
          f"analysis {secs['analysis']:.4f} s in "
          f"{len(calls['analysis'])} per-lane calls "
          f"({secs['analysis'] / wall:.1%}), rate loop "
          f"{secs['rate loop']:.4f} s in {len(calls['rate loop'])} calls "
          f"({secs['rate loop'] / wall:.1%}), the rest "
          f"{wall - secs['analysis'] - secs['rate loop']:.4f} s; device "
          f"kernels and copies (torch.profiler): analysis "
          f"{kernels['analysis']}, rate loop {kernels['rate loop']}, whole "
          f"group {kernels['whole group']}", flush=True)


def phase_corpus(ctx, line, cfg_of):
    """Phase 10: encode_corpus_batched on the card; returns the launches
    of one 32-clip encode at lane batch 16 and bits_at's numbers on the
    captured 32,768-lane batch."""
    np, mpeg = ctx["np"], ctx["mpeg"]
    decode_mp3, snr_db = ctx["decode_mp3"], ctx["snr_db"]
    from mp3tpu_torch.parallel.corpus import encode_corpus_batched
    from mp3tpu_torch.tools import quality
    from mp3tpu_torch.tools.corpus_sweep import (CORPUS_CFG, RATE, corpus,
                                                 sweep)
    kw, rate = CORPUS_CFG, RATE
    clips = corpus(CORPUS_CLIPS, CORPUS_SECONDS)
    audio = CORPUS_CLIPS * CORPUS_SECONDS
    counts_of, first_of = {}, {}

    def around(batch, i, encode):
        """Run i of the sweep at `batch`: the first with the launch
        counts reset before and read after, the others equal to it."""
        if i == 0:
            reset_counts(ctx)
        outs, stats = encode()
        if i == 0:
            counts_of[batch] = read_counts(ctx,
                                           f"corpus at lane batch {batch}")
            first_of[batch] = outs
        elif outs != first_of[batch]:
            fail(f"corpus at lane batch {batch}: two runs differ")
        return outs, stats

    for rec in sweep(clips, CORPUS_BATCHES, "cuda", TIMED_RUNS, around):
        batch, walls, wall = rec["lane_batch"], rec["walls_s"], rec["wall_s"]
        counts = counts_of[batch]
        for out in first_of[batch]:
            check_grid(out, 128, rate, int(CORPUS_SECONDS * rate))
        groups = -(-CORPUS_CLIPS // batch)
        print(f"corpus: {CORPUS_CLIPS} stereo 44.1 kHz 128 kbps clips x "
              f"{CORPUS_SECONDS:.0f} s, lane batch {batch}: aggregate "
              f"{audio / wall:.2f}x real time, wall {wall:.4f} s median of "
              f"{TIMED_RUNS} ({', '.join(f'{w:.4f}' for w in walls)} s); "
              f"K3 launches {counts['search']} in {groups} groups "
              f"({counts['search'] / groups:.1f} a group), bits_at "
              f"{counts['bits_at']}, loop-exit syncs {counts['syncs']} on "
              f"{line}",
              flush=True)
    launches = counts_of[CORPUS_BATCHES[-1]]

    for batch in (1, CORPUS_BATCHES[-1]):
        group_split(ctx, clips[:batch], kw)

    # the eight stereo 44.1 kHz 128 kbps quality fixtures as one group
    golden = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden, "ref_snr.json")) as f:
        ref = json.load(f)
    names = [n for n, mode, kbps, r in quality.CASES
             if mode == mpeg.MODE_STEREO and kbps == 128 and r == rate]
    pcms = [ctx["read_wav"](os.path.join(golden, f"{n}.wav"))[0]
            for n in names]
    outs, _ = encode_corpus_batched([(p, rate) for p in pcms], kw, "cuda",
                                    batch=len(names))
    same, worst, gap = 0, None, 0.0
    for name, pcm, out in zip(names, pcms, outs):
        one = ctx["encode"](pcm, cfg_of(), device="cuda")
        check_grid(out, 128, rate, pcm.shape[0])
        if len(out) != len(one):
            fail(f"corpus {name}: {len(out)} bytes, one-shot {len(one)}")
        same += out == one
        dec, _ = decode_mp3(out)
        dec1, _ = decode_mp3(one)
        for c in range(2):
            s = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
            s1 = float(snr_db(pcm[:, c].astype(np.float64), dec1[:, c]))
            if not np.isfinite(s) or s < ref[name][c] or abs(s - s1) >= 0.5:
                fail(f"corpus {name} ch{c}: SNR {s:.2f} dB, bar "
                     f"{ref[name][c]} dB, one-shot {s1:.2f} dB")
            gap = max(gap, abs(s - s1))
            if worst is None or s - ref[name][c] < worst[0]:
                worst = (s - ref[name][c], name, c)
    print(f"corpus quality: the {len(names)} stereo 44.1 kHz 128 kbps "
          f"fixtures ({', '.join(str(len(p)) for p in pcms)} samples) as one "
          f"group: at or above their ref_snr.json bars (worst margin "
          f"{worst[0]:+.2f} dB, {worst[1]} ch{worst[2]}), within 0.5 dB of "
          f"their one-shot encodes (largest gap {gap:.4f} dB); {same} of "
          f"{len(names)} byte-identical to the one-shot", flush=True)

    group = clips[:CORPUS_BATCHES[-1]]
    from mp3tpu_torch.encoder import _plan_segments
    lanes = 2 * len(group) * _plan_segments(
        2 * -(-int(CORPUS_SECONDS * rate) // 1152))[0][2]
    captured, err, s_err, b_err = path_batch_check(
        ctx, lambda: encode_corpus_batched(group, kw, "cuda",
                                           batch=len(group)),
        lanes, f"corpus group of {len(group)}")
    k_dev, p_dev, _, b_ms, b_by = bits_at_timed(
        ctx, "corpus batch", first_evaluation(captured))
    k3 = search_timed(ctx, "corpus batch", "stepsize", *captured,
                      plain_too=True)
    return dict(launches=launches, max_abs_err=err, ms=k_dev,
                plain_ms=p_dev, bound_ms=b_ms, bound_by=b_by,
                search_max_abs_err=s_err, baseline_max_abs_err=b_err,
                search=k3)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_lanes(G, world):
    """The lanes of one rank's bit evaluations in encode_layer3_sharded:
    its chunks x 2 channels x the chunk size (parallel/clip.py's grid)."""
    from mp3tpu_torch.encoder import _chunk_size
    C = _chunk_size(-(-G // world))
    K = -(-(-(-G // C)) // world) * world
    return K // world * 2 * C



def sharded_rank(rank, world, url, out):
    """One rank of phase 11's gloo group, run as
    python3 chip_smoke.py --sharded-rank RANK WORLD URL OUT: the bench clip
    through encode_layer3_sharded on cuda:0 over a "cpu" mesh, once to warm
    up and once timed, then once more with this rank's bit evaluation
    captured and bits_at held against its plain chain on it; writes the
    stream to OUT and the seconds and the max abs error to OUT.json."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        fail("sharded rank: no CUDA device")
    from mp3tpu_torch.config import EncoderConfig
    from mp3tpu_torch.ops import loop
    from mp3tpu_torch.parallel.clip import encode_layer3_sharded
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.sharding import make_mesh
    from mp3tpu_torch.tables import mpeg
    init_distributed(url, world, rank, "gloo")
    try:
        mesh = make_mesh("cpu", world)
        pcm = make_signal(CLIP_SECONDS, 44100)

        def encode():
            cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                                bitrate_kbps=128, sample_rate_hz=44100)
            return encode_layer3_sharded(pcm, cfg, "cuda", mesh=mesh)

        encode()
        dist.barrier()
        t0 = time.perf_counter()
        data = encode()
        wall = time.perf_counter() - t0
        _, err, s_err, b_err = path_batch_check(
            dict(torch=torch, loop=loop), encode,
            sharded_lanes(2 * -(-len(pcm) // 1152), world),
            f"sharded path (world {world}, rank {rank})")
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        f.write(data)
    with open(out + ".json", "w") as f:
        json.dump({"wall_s": wall, "max_abs_err": err,
                   "search_max_abs_err": s_err,
                   "baseline_max_abs_err": b_err}, f)


def phase_sharded(ctx, cfg_of, line):
    """Phase 11: dryrun_multichip(1) on an NCCL mesh; the bench clip
    through encode_layer3_sharded at world size 1 (NCCL, this process) and
    2 (gloo, two processes, both on cuda:0), each held to the one-shot
    encode at the same chunk, and bits_at held against its plain chain on
    each run's own bit-evaluation batch.  Returns the launches of the
    world-1 encode and the largest error of those checks."""
    np, torch = ctx["np"], ctx["torch"]
    import torch.distributed as dist
    from mp3tpu_torch.decoder.layer3 import stream_block_types
    from mp3tpu_torch.encoder import _chunk_size
    from mp3tpu_torch.parallel.clip import encode_layer3_sharded
    from mp3tpu_torch.parallel.corpus import init_distributed
    from mp3tpu_torch.parallel.dryrun import dryrun_multichip
    pcm = make_signal(CLIP_SECONDS, 44100)
    G = 2 * -(-len(pcm) // 1152)
    streams = {}

    rank, world = init_distributed(f"localhost:{free_port()}", 1, 0, "nccl")
    try:
        t0 = time.perf_counter()
        dry = dryrun_multichip(1, "cuda")
        print(f"dryrun_multichip(1) on an NCCL mesh: encode_sharded and a "
              f"{len(dry)}-byte stream in {time.perf_counter() - t0:.2f} s",
              flush=True)
        encode_layer3_sharded(pcm, cfg_of(), "cuda")             # warm-up
        reset_counts(ctx)
        t0 = time.perf_counter()
        streams[1] = encode_layer3_sharded(pcm, cfg_of(), "cuda")
        walls = {1: [time.perf_counter() - t0]}
        launches = read_counts(ctx, "sharded path")
        n_sh = profile_once(
            lambda: encode_layer3_sharded(pcm, cfg_of(), "cuda"))[0]
        _, err, s_err, b_err = path_batch_check(
            ctx, lambda: encode_layer3_sharded(pcm, cfg_of(), "cuda"),
            sharded_lanes(G, 1), "sharded path (world 1)")
        errs, s_errs, b_errs = [err], [s_err], [b_err]
    finally:
        dist.destroy_process_group()

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rendezvous = os.path.join(work, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    env = dict(os.environ, PYTHONPATH=ROOT,
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    outs = [os.path.join(work, f"sharded{r}.mp3") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
         "2", f"file://{rendezvous}", outs[r]], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            said, err = p.communicate(timeout=600)
            for text in said.decode(errors="replace").splitlines():
                print(f"rank {r} of 2: {text}", flush=True)
            if p.returncode != 0:
                fail(f"sharded rank {r} of 2: rc {p.returncode}\n"
                     f"{err.decode(errors='replace')[-3000:]}")
    finally:
        for p in procs:
            p.kill()
    ranks = []
    walls[2] = []
    for out in outs:
        with open(out, "rb") as f:
            ranks.append(f.read())
        with open(out + ".json") as f:
            res = json.load(f)
        walls[2].append(res["wall_s"])
        errs.append(res["max_abs_err"])
        s_errs.append(res["search_max_abs_err"])
        b_errs.append(res["baseline_max_abs_err"])
    if ranks[0] != ranks[1]:
        fail("the two gloo ranks returned different streams")
    streams[2] = ranks[0]

    one_shot = {}
    for world, data in sorted(streams.items()):
        chunk = _chunk_size(-(-G // world))
        if chunk not in one_shot:
            t0 = time.perf_counter()
            one = ctx["encode"](pcm, cfg_of(), device="cuda", chunk=chunk)
            wall1 = time.perf_counter() - t0
            fsize, _ = check_grid(one, 128, 44100, len(pcm))
            n_one = profile_once(lambda: ctx["encode"](
                pcm, cfg_of(), device="cuda", chunk=chunk))[0]
            one_shot[chunk] = (one, wall1, n_one, first_seconds_snr(
                np, one, pcm, fsize, 10.0, ctx["decode_mp3"], ctx["snr_db"]))
        one, wall1, n_one, snr1 = one_shot[chunk]
        if len(data) != len(one):
            fail(f"sharded world {world}: {len(data)} bytes, one-shot at "
                 f"chunk {chunk} {len(one)}")
        bt = stream_block_types(data)
        if not np.array_equal(bt, stream_block_types(one)):
            fail(f"sharded world {world}: block types differ from the "
                 f"one-shot at chunk {chunk}")
        snr = first_seconds_snr(np, data, pcm, fsize, 10.0, ctx["decode_mp3"],
                                ctx["snr_db"])
        for s, s1 in zip(snr, snr1):
            if not np.isfinite(s) or abs(s - s1) >= 0.5:
                fail(f"sharded world {world}: first-10 s SNR {s:.2f} dB, "
                     f"one-shot {s1:.2f} dB")
        how = ("NCCL, this process" if world == 1
               else "gloo, two processes on cuda:0")
        print(f"sharded {CLIP_SECONDS:.0f} s stereo 128 kbps, world size "
              f"{world} ({how}), "
              f"chunk {chunk}: {len(data)} bytes, "
              f"{'byte-identical to' if data == one else 'differs from'} the "
              f"one-shot at chunk {chunk}; block types equal "
              f"({int((bt != 0).sum())} non-long); first 10 s SNR {snr} dB "
              f"(one-shot {snr1}); timed wall "
              f"{', '.join(f'{w:.3f}' for w in walls[world])} s "
              f"({', '.join(f'{CLIP_SECONDS / w:.2f}x' for w in walls[world])}"
              f" real time; one-shot at chunk {chunk}: {wall1:.3f} s) on "
              f"{line}", flush=True)
    print(f"sharded world 1: {n_sh} device kernels and copies per encode "
          f"(torch.profiler), one-shot at chunk {_chunk_size(G)}: "
          f"{one_shot[_chunk_size(G)][2]}", flush=True)
    return dict(launches=launches, max_abs_err=max(errs),
                search_max_abs_err=max(s_errs),
                baseline_max_abs_err=max(b_errs))


def phase_trace(ctx, pcm, cfg_of, main_out):
    """Phase 12a: runtime.profiling.trace around one bench encode; the
    trace must hold every named span and one search_kernel event per K3
    launch (and as many bits_at_kernel events as bits_at launches: none;
    asked up to 3 times: the profiler now and then records no device
    event in a window)."""
    from mp3tpu_torch.runtime.profiling import SPANS, trace
    from mp3tpu_torch.tools.trace_stages import span_breakdown
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(3):
            reset_counts(ctx)
            with trace(tmp, "cuda"):
                t0 = time.perf_counter()
                out = ctx["encode"](pcm, cfg_of(), device="cuda")
                wall = time.perf_counter() - t0
            launches = read_counts(ctx, "traced main path")
            path = os.path.join(tmp, "trace.json")
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            bd = span_breakdown(path)
            parse_s = time.perf_counter() - t0
            if (bd["search_kernel_events"], bd["bits_at_kernel_events"]) \
                    == (launches["search"], launches["bits_at"]):
                break
            print(f"trace attempt {attempt + 1}: "
                  f"{bd['search_kernel_events']} search_kernel and "
                  f"{bd['bits_at_kernel_events']} bits_at_kernel events "
                  f"against launches {launches}; asking again", flush=True)
        else:
            fail("the trace never held one search_kernel event per K3 "
                 "launch")
    if out != main_out:
        fail("the traced encode gave other bytes than phase 5's")
    missing = [n for n in SPANS if bd["spans"][n]["count"] == 0]
    if missing:
        fail(f"the trace lacks the spans {missing}")
    print(f"trace: trace.json of {size} bytes parsed in {parse_s:.2f} s; "
          f"encode under the trace {wall:.3f} s, the same bytes as phase 5; "
          f"{bd['device_events']} device events ({bd['device_s']:.4f} s of "
          f"device time), {bd['unlinked_events']} without their launching "
          f"call in the trace; search_kernel events "
          f"{bd['search_kernel_events']} = search.launches "
          f"{launches['search']}, bits_at_kernel events "
          f"{bd['bits_at_kernel_events']}; loop-exit syncs "
          f"{launches['syncs']}",
          flush=True)
    for name in SPANS:
        r = bd["spans"][name]
        print(f"span {name}: {r['count']} x, host {r['host_s']:.4f} s "
              f"({r['host_s'] / wall:.1%} of the traced wall; self "
              f"{r['self_host_s']:.4f} s, {r['self_host_s'] / wall:.1%}); "
              f"device events {r['device_events']} (self "
              f"{r['self_device_events']}), device "
              f"{r['device_s'] * 1e3:.3f} ms (self "
              f"{r['self_device_s'] * 1e3:.3f} ms)", flush=True)


def phase_conformance(ctx, main_out, pcm):
    """Phase 12d: libmpg123 on the card's 60 s streams (main path, LSF,
    Layer II): the rate, the channels and the length; per channel its
    best-lag SNR over the clip and over the first 10 s, the in-repo
    decoder's over the first 10 s (it must not be more than 0.5 dB
    better) and the two decoders' agreement there (best-lag SNR of
    mpg123's output against the in-repo decoder's, at least 20 dB as in
    tests/test_conformance.py)."""
    from mp3tpu_torch.runtime import mpg123
    from mp3tpu_torch.tools.quality import best_lag_snr
    if not mpg123.available():
        print("conformance: libmpg123 is absent on this machine; the "
              "streams are not cross-decoded", flush=True)
        return
    print("conformance: libmpg123 is present", flush=True)
    streams = dict(ctx["streams"])
    streams["main path 60 s stereo 44.1 kHz 128 kbps"] = (
        main_out, pcm, 44100, 417, 1152, ctx["decode_mp3"])
    for label, (out, ref, rate, fsize, spf, decode) in streams.items():
        theirs, drate = mpg123.decode(out)
        nch = ref.shape[1]
        if drate != rate or theirs.shape[1] != nch \
                or theirs.shape[0] < len(ref) - 2 * 1152:
            fail(f"mpg123 on the {label} stream: rate {drate}, shape "
                 f"{theirs.shape} for {ref.shape} at {rate} Hz")
        nf = -(-int(10.0 * rate) // spf)
        ours = decode(out[:nf * fsize])[0] * 32768.0
        n10 = int(10.0 * rate)
        rows = []
        for c in range(nch):
            whole = best_lag_snr(ref[:, c], theirs[:, c])
            mpg10 = best_lag_snr(ref[:n10, c], theirs[:, c])
            ours10 = best_lag_snr(ref[:n10, c], ours[:, c])
            agree = best_lag_snr(ours[:n10, c], theirs[:, c])
            if not agree >= 20.0 or not mpg10 >= ours10 - 0.5:
                fail(f"mpg123 on the {label} stream ch{c}: agreement "
                     f"{agree:.2f} dB, first-10 s SNR {mpg10:.2f} dB "
                     f"against the in-repo decoder's {ours10:.2f} dB")
            rows.append(f"ch{c} {whole:.2f} dB over the clip, first 10 s "
                        f"{mpg10:.2f} dB (in-repo decoder {ours10:.2f} dB), "
                        f"agreement {agree:.2f} dB")
        print(f"conformance, {label} ({len(out)} bytes): mpg123 decodes "
              f"{theirs.shape[0]} samples x {nch} at {drate} Hz; "
              f"best-lag SNR {'; '.join(rows)}", flush=True)


def phase_tooling(ctx, pcm, cfg_of, main_out):
    """Phase 12: the trace, the trace_stages and profile_encode tools on
    the bench clip, and libmpg123 on the card's streams."""
    from mp3tpu_torch.tools import profile_encode, trace_stages
    phase_trace(ctx, pcm, cfg_of, main_out)
    t0 = time.perf_counter()
    stages = trace_stages.run(CLIP_SECONDS, "cuda")
    if stages["bytes"] != len(main_out) or \
            not all(t > 0 for t in stages["stage_isolated_s"].values()):
        fail(f"trace_stages: {stages['bytes']} bytes, stages "
             f"{stages['stage_isolated_s']}")
    print(f"trace_stages ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(stages)}", flush=True)
    t0 = time.perf_counter()
    record = profile_encode.run(CLIP_SECONDS, "cuda")
    if record["bytes"] != len(main_out) or not record["flop_counter_flops"]:
        fail(f"profile_encode: {record['bytes']} bytes, "
             f"{record['flop_counter_flops']} FLOPs")
    print(f"profile_encode ({time.perf_counter() - t0:.2f} s): "
          f"{json.dumps(record)}", flush=True)
    phase_conformance(ctx, main_out, pcm)


def phase_build(k1, K):
    """Phase 2: build both kernel libraries, one nvcc process each,
    started together; prints bits_at.cu's -Xptxas -v report (its two
    kernels, bits_at_kernel and K3's search_kernel)."""
    jobs = ((k1, ()), (K, ("-Xptxas", "-v")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(mod.build, True, extra) for mod, extra in jobs]
        logs = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    for mod, extra in jobs:
        print(f"build: {os.path.relpath(mod.LIBRARY, ROOT)} from "
              f"{os.path.relpath(mod.SOURCE, ROOT)} (nvcc "
              f"{' '.join(list(mod.NVCC_FLAGS) + list(extra))})", flush=True)
    print(f"build: both libraries in {wall:.2f} s", flush=True)
    print("build: ptxas report for bits_at.cu:\n" + logs[1].strip(),
          flush=True)


def phase_main(ctx, pcm, cfg, line):
    """Phase 5: the bench clip five ways: the plain searches with the
    plain chain, the plain searches with the K1 chain, the plain searches
    on bits_at (the lockstep path), K3's first design, each swapped in by
    this script, and as the package runs it (K3); the five streams must
    be equal, and the launch counts must show that each swap took effect.
    The lockstep path and K3 are timed in turns and profiled once each.
    Returns the package run's counts and measurements."""
    np, torch, loop, K = ctx["np"], ctx["torch"], ctx["loop"], ctx["K"]
    encode, decode_mp3, snr_db = (ctx["encode"], ctx["decode_mp3"],
                                  ctx["snr_db"])
    real = dict(_bits_at=loop._bits_at, search_stepsize=loop.search_stepsize,
                search_walk=loop.search_walk)
    plain_searches = dict(search_stepsize=loop.search_stepsize_plain,
                          search_walk=loop.search_walk_plain)
    baseline = dict(search_stepsize=ctx["S"].baseline_stepsize,
                    search_walk=ctx["S"].baseline_walk)

    def plain_chain(xr75p, qss, is_short, is_short_block, ST):
        c = K.bits_at_plain(xr75p, qss, is_short, is_short_block, ST)
        return c["bits"], c

    def k1_chain(xr75p, qss, is_short, is_short_block, ST):
        """The evaluation before bits_at: plain PyTorch around one K1
        launch."""
        ixp = loop.quantize_pow75(xr75p, qss)
        c = loop.count_all(ixp, is_short, is_short_block, ST,
                           pre_permuted=True)
        c["bits"] = torch.where(c["ix_max"] <= loop.IXMAX, c["bits"], 1e9)
        return c["bits"], c

    # the five ways: the functions swapped into loop, and the launch
    # counts that must be 0 / more than 0 after each
    ways = {"plain": (dict(plain_searches, _bits_at=plain_chain),
                      ("search", "bits_at", "hist_c1", "baseline"), ()),
            "k1": (dict(plain_searches, _bits_at=k1_chain),
                   ("search", "bits_at", "baseline"), ("hist_c1",)),
            "pr5": (plain_searches, ("search", "hist_c1", "baseline"),
                    ("bits_at",)),
            "baseline": (baseline, ("search", "bits_at", "hist_c1"),
                         ("baseline",)),
            "k3": ({}, ("bits_at", "hist_c1", "baseline"), ("search",))}
    label = {"plain": "plain", "k1": "K1 chain", "pr5": "the lockstep path",
             "baseline": "K3's first design", "k3": "K3"}

    def run(way, swaps=None):
        swaps = ways[way][0] if swaps is None else swaps
        for name, fn in swaps.items():
            setattr(loop, name, fn)
        try:
            return encode(pcm, cfg, device="cuda")
        finally:
            for name in swaps:
                setattr(loop, name, real[name])

    def counted(way, swaps=None):
        reset_counts(ctx)
        t0 = time.perf_counter()
        out = run(way, swaps)
        wall = time.perf_counter() - t0
        counts = launch_counts(ctx)
        zero, more = ways[way][1:]
        if any(counts[k] for k in zero) or not all(counts[k] for k in more):
            fail(f"main path, {label[way]}: launches {counts}: the swap did "
                 f"not take effect")
        return out, counts, wall

    outs, counts = {}, {}
    for way in ("plain", "k1", "pr5", "baseline"):
        outs[way], counts[way], _ = counted(way)
    # K3's counted run also records each search's evaluation counts and
    # the evaluations K3 ran
    evals, runs = [], []

    def recording(fn):
        def record(*args, **kwargs):
            res = fn(*args, **kwargs)
            evals.append(res[2]["evals"])
            runs.append(res[2]["runs"])
            return res
        return record

    out, launches, first_s = counted(
        "k3", {k: recording(real[k]) for k in plain_searches})
    for way, o in outs.items():
        if o != out:
            fail(f"main path with K3 ({len(out)} bytes) != with "
                 f"{label[way]} ({len(o)} bytes)")
    # a plain search launches bits_at as often as its slowest granule
    # evaluates in K3
    lockstep = sum(int(e.max()) for e in evals)
    per_granule = sum(int(e.sum()) for e in evals)
    ran = sum(int(r.sum()) for r in runs)
    if lockstep != counts["pr5"]["bits_at"]:
        fail(f"K3's evaluation counts give {lockstep} lockstep evaluations; "
             f"the lockstep path launched bits_at "
             f"{counts['pr5']['bits_at']} times")
    fsize, nframes = check_grid(out, 128, 44100, pcm.shape[0])
    from mp3tpu_torch.encoder import _plan_segments
    plan = _plan_segments(nframes * 2)
    print(f"main path: the plain searches with the plain chain, with the K1 "
          f"chain, on bits_at (the lockstep path), K3's first design and K3: "
          f"the same {len(out)} bytes", flush=True)
    for way in ("plain", "k1", "pr5", "baseline"):
        print(f"main path ({label[way]}): launches and loop-exit syncs per "
              f"encode {counts[way]}", flush=True)
    print(f"main path (K3, first run): {first_s:.3f} s; launches and "
          f"loop-exit syncs per encode {launches}; {len(evals)} searches, "
          f"{lockstep} lockstep evaluations (= the lockstep path's bits_at "
          f"launches), "
          f"{per_granule} granule evaluations as the plain schedule counts "
          f"them, {ran} run by K3; {len(plan)} segments "
          f"{[(n_pad * 2) for _, _, n_pad in plan]} lanes (each adds 2 syncs: "
          f"scan input, result download)", flush=True)

    times = {"pr5": [], "k3": []}
    for way in ("pr5", "k3", "k3", "pr5") * TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = run(way)
        times[way].append(time.perf_counter() - t0)
        if out_t != out:
            fail(f"a timed encode ({label[way]}) gave other bytes")
    wall = statistics.median(times["k3"])
    wall_pr5 = statistics.median(times["pr5"])
    print(f"main path: 60 s stereo 128 kbps in {wall:.3f} s median of "
          f"{2 * TURNS} ({', '.join(f'{t:.3f}' for t in times['k3'])} "
          f"s): {CLIP_SECONDS / wall:.2f}x real time on {line}; in turns with "
          f"the lockstep path: {wall_pr5:.3f} s median "
          f"({', '.join(f'{t:.3f}' for t in times['pr5'])} s), "
          f"{CLIP_SECONDS / wall_pr5:.2f}x; K3's wall {wall / wall_pr5:.3f} "
          f"of the lockstep path's", flush=True)

    for way, median in (("pr5", wall_pr5), ("k3", wall)):
        for _ in range(3):      # the profiler now and then records none
            n, busy, pwall = profile_once(lambda: run(way))
            if n > 0:
                break
        else:
            fail(f"torch.profiler recorded no device event ({label[way]})")
        print(f"torch.profiler over one encode ({label[way]}): {n} device "
              f"kernels and copies; device busy {busy:.4f} s of a profiled "
              f"wall of {pwall:.4f} s, idle share {1.0 - busy / pwall:.3f} "
              f"(against the unprofiled median {median:.3f} s: "
              f"{1.0 - busy / median:.3f})", flush=True)

    # K3's device time summed over one encode, and its first design's with
    # the baseline swapped in, in turns
    k3_ms = {"k3": [], "baseline": []}
    for way in ("baseline", "k3", "k3", "baseline"):
        name = "search_kernel(" if way == "k3" else "search_baseline("
        for _ in range(3):      # until the window holds every launch
            count, ms = kernel_events(lambda: run(way), (name,))[name]
            if count == launches["search"]:
                break
        else:
            print(f"  (main path, {label[way]}: the profiler recorded "
                  f"{count} of {launches['search']} {name} events)",
                  flush=True)
            ms = None
        k3_ms[way].append(ms)
    print(f"main path, the searches' kernel summed over one encode "
          f"(torch.profiler, {launches['search']} launches; turns baseline, "
          f"K3, K3, baseline): K3 {' / '.join(map(str, k3_ms['k3']))} ms, "
          f"K3's first design {' / '.join(map(str, k3_ms['baseline']))} ms",
          flush=True)

    snr_gpu = first_seconds_snr(np, out, pcm, fsize, 10.0, decode_mp3,
                                snr_db)
    short = pcm[:int(10.0 * 44100)]
    out_cpu = encode(short, cfg, device="cpu")
    snr_cpu = first_seconds_snr(np, out_cpu, short, fsize, 10.0, decode_mp3,
                                snr_db)
    print(f"decoded SNR of the first 10 s: cuda {snr_gpu} dB, cpu path "
          f"{snr_cpu} dB", flush=True)
    for g, c in zip(snr_gpu, snr_cpu):
        if not np.isfinite(g) or g < c - 1.0:
            fail(f"first-10 s SNR {g:.2f} dB is more than 1 dB below the "
                 f"CPU path's {c:.2f} dB")
    return dict(launches=launches, by_way=counts, out=out,
                k3_encode_ms=k3_ms)


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    line = card_line()
    print(line, flush=True)
    print(f"card: {line} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))",
          flush=True)

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import mp3tpu_torch  # noqa: F401  (TF32 off)
    from mp3tpu_torch.config import EncoderConfig
    from mp3tpu_torch.decoder import decode_mp3
    from mp3tpu_torch.decoder.layer3 import snr_db
    from mp3tpu_torch.encoder import encode_layer3_fast
    from mp3tpu_torch.ops import bits_at as K
    from mp3tpu_torch.ops import hist_c1 as k1
    from mp3tpu_torch.ops import loop
    from mp3tpu_torch.ops import search as S
    from mp3tpu_torch.runtime.wav import read_wav
    from mp3tpu_torch.tables import mpeg

    phase_build(k1, K)
    kres = phase_kernel(k1, torch)

    ctx = dict(np=np, torch=torch, k1=k1, K=K, S=S, loop=loop,
               EncoderConfig=EncoderConfig, mpeg=mpeg,
               encode=encode_layer3_fast, decode_mp3=decode_mp3,
               snr_db=snr_db, read_wav=read_wav, make_signal=make_signal,
               streams={})

    def cfg_of():
        return EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                             bitrate_kbps=128, sample_rate_hz=44100)

    # ---- the main path: 60 s stereo 44.1 kHz 128 kbps
    pcm = make_signal(CLIP_SECONDS, 44100)
    main_searches = capture_main_searches(ctx, pcm, cfg_of())
    t0 = time.perf_counter()
    bres = phase_bits_at(ctx, first_evaluation(
        main_searches[4096]["stepsize"]))
    print(f"phase 3b bits_at: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    sres = phase_search(ctx, main_searches)
    print(f"phase 3c K3: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    phase_quality()
    print(f"phase 4 quality: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    main_res = phase_main(ctx, pcm, cfg_of(), line)
    print(f"phase 5 main path: {time.perf_counter() - t0:.2f} s", flush=True)

    phases = [("6 LSF", lambda: phase_lsf(ctx)),
              ("7 streaming", lambda: phase_stream(ctx, pcm, cfg_of)),
              ("8 Layers I/II", lambda: phase_layer12(ctx)),
              ("9 CLI", lambda: phase_cli(ctx, pcm, cfg_of)),
              ("10 corpus", lambda: phase_corpus(ctx, line, cfg_of)),
              ("11 multi-device", lambda: phase_sharded(ctx, cfg_of, line)),
              ("12 tooling", lambda: phase_tooling(ctx, pcm, cfg_of,
                                                   main_res["out"]))]
    counts = {}
    for name, run in phases:
        t0 = time.perf_counter()
        counts[name] = run()
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    corpus, sharded = counts["10 corpus"], counts["11 multi-device"]
    print(f"bits_at on the corpus path's 32,768-lane batch: max_abs_err "
          f"{corpus['max_abs_err']}, {corpus['ms']} ms against the plain "
          f"chain's {corpus['plain_ms']} ms and a bound of "
          f"{corpus['bound_ms']:.6f} ms ({corpus['bound_by']}); on the "
          f"sharded path's batches: max_abs_err {sharded['max_abs_err']}",
          flush=True)
    k3 = corpus["search"]
    print(f"K3 on the corpus path's 32,768-lane stepsize search: max_abs_err "
          f"{corpus['search_max_abs_err']}, {k3['ms']} ms (K3's first design "
          f"{k3['baseline_ms']} ms) against the plain search's "
          f"{k3['plain_ms']} ms ({k3['plain_launches']} bits_at launches) "
          f"and a bound of {k3['bound_ms']:.6f} ms ({k3['bound_by']}); on the "
          f"sharded path's: max_abs_err {sharded['search_max_abs_err']}",
          flush=True)

    launches = main_res["launches"]

    def by_path(kernel):
        return {"main": launches[kernel], "lsf": counts["6 LSF"][kernel],
                "stream": counts["7 streaming"][kernel],
                "corpus": corpus["launches"][kernel],
                "sharded": sharded["launches"][kernel]}

    for kernel in ("search", "baseline", "bits_at", "syncs"):
        print(f"{kernel} {'per encode' if kernel == 'syncs' else 'launches'}"
              f" by path: {by_path(kernel)}", flush=True)

    err, k_ms, p_ms, (b_ms, b_by) = kres[4096]
    print(json.dumps({"kernels": [
        {"name": "hist_c1", "route": "cuda",
         "source": "mp3tpu_torch/csrc/hist_c1.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["hist_c1"], "max_abs_err": err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "launches_by_path": dict(
             by_path("hist_c1"),
             main_k1_chain=main_res["by_way"]["k1"]["hist_c1"])},
        {"name": "bits_at", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["bits_at"],
         "max_abs_err": max(bres["max_abs_err"], corpus["max_abs_err"],
                            sharded["max_abs_err"]),
         "ms": bres["ms"], "plain_ms": bres["plain_ms"],
         "bound_ms": bres["bound_ms"], "bound_by": bres["bound_by"],
         "library_ms": None, "launches_by_path": dict(
             by_path("bits_at"),
             main_plain_searches=main_res["by_way"]["pr5"]["bits_at"])},
        {"name": "search", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/jaxloop.py:528-613",
         "launches": launches["search"],
         "max_abs_err": max(sres["max_abs_err"],
                            corpus["search_max_abs_err"],
                            sharded["search_max_abs_err"]),
         "ms": sres["ms"], "plain_ms": sres["plain_ms"],
         "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
         "library_ms": None, "launches_by_path": by_path("search"),
         "width": sres["width"], "runs": sres["runs"], "evals": sres["evals"],
         "encode_ms": main_res["k3_encode_ms"]["k3"]},
        {"name": "search_baseline", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/jaxloop.py:528-613",
         "launches": launches["baseline"],
         "max_abs_err": max(sres["baseline_max_abs_err"],
                            corpus["baseline_max_abs_err"],
                            sharded["baseline_max_abs_err"]),
         "ms": sres["baseline_ms"], "plain_ms": sres["plain_ms"],
         "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
         "library_ms": None, "launches_by_path": dict(
             by_path("baseline"),
             main_swapped_in=main_res["by_way"]["baseline"]["baseline"]),
         "encode_ms": main_res["k3_encode_ms"]["baseline"]}]}),
          flush=True)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5])
    else:
        main()
