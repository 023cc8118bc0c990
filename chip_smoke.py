#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mp3tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build both kernels, K1 (mp3tpu_torch/csrc/hist_c1.cu) and bits_at
     (csrc/bits_at.cu, with -Xptxas -v, whose report is printed), one
     nvcc process each, started together; timed;
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
     path's own first 4096-lane evaluation at six stepsizes; timed
     (kernel device and call time, the plain chain's device time, K1's
     device time on the same quantized batch) beside the bound;
  4. the 15 quality fixtures of tests/test_fast_encoder.py through
     encode_layer3_fast(device="cuda"): frame grid and the reference
     encoder's decoded-SNR bars (in-repo decoder);
  5. the main path: the 60 s stereo 44.1 kHz 128 kbps clip of bench.py
     (its signal, copied here), encoded with loop._bits_at swapped (by
     this script) for the plain chain, then for the chain of K1 with
     plain PyTorch around it, then as the package runs it with the
     launch counts reset before and read after; the three streams must
     be equal byte for byte.  Then the K1 chain and the package in turns
     (3 timed runs each), one encode of each under torch.profiler (device
     kernels and copies, device idle share); the stream must sit on the
     frame grid and its first 10 s must decode within 1 dB of the CPU
     path's 10 s encode;
  6. MPEG-2 LSF: the three 0.5 s mono cases of tests/test_lsf.py, then a
     60 s stereo 24 kHz 64 kbps clip (launches counted), interior
     frames on the grid, first 10 s within 1 dB of the CPU path;
  7. streaming: the bench clip in 1 s pieces through StreamEncoder at
     window 1024 (launches counted, timed) must equal the one-shot
     encode at chunk 1024 byte for byte, and so must a run checkpointed
     at 30 s, pickled and resumed in a fresh encoder;
  8. Layers I/II: the six fixtures of tests/test_layer12_fast.py and its
     CRC case, then a 60 s stereo 44.1 kHz Layer II 192 kbps clip (frame
     grid, timed, first 10 s within 0.5 dB of the CPU path);
  9. the command line: python -m mp3tpu_torch on a 10 s WAV and on raw
     PCM piped to stdin must write the library's bytes.
Its last lines are a JSON object describing the kernels and then
{"ok": true, "device": {...}}.  It imports nothing of JAX and nothing of
the JAX package.
"""
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIP_SECONDS = 60.0
TIMED_RUNS = 3
# NVIDIA H100 SXM, data sheet: HBM rate, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_signal(seconds, rate):
    """bench.py's 60 s test signal: two tones and noise per channel."""
    import numpy as np
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.RandomState(42)
    x = (0.35 * np.sin(2 * np.pi * 440.0 * t)
         + 0.15 * np.sin(2 * np.pi * 1871.0 * t)
         + 0.08 * rng.randn(len(t)))
    y = (0.3 * np.sin(2 * np.pi * 554.0 * t + 0.3)
         + 0.1 * rng.randn(len(t)))
    pcm = np.stack([x, y], axis=1)
    return np.clip(pcm * 24000, -32768, 32767).astype(np.int16)


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


def profile_once(torch, fn):
    """One fn() under torch.profiler: (device kernels and copies, device
    busy s, profiled wall s).  Busy is the union of the device events'
    intervals; the wall is the host clock around fn and a synchronize."""
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


def capture_main_batch(ctx, pcm, cfg):
    """The main path's first 4096-lane bit evaluation, recorded by
    wrapping loop._bits_at during one encode of the bench clip:
    (xr75p, qss, is_short, is_short_block, ST)."""
    loop = ctx["loop"]
    real = loop._bits_at
    seen = []

    def record(xr75p, qss, is_short, is_short_block, ST):
        if not seen and xr75p.shape[0] == 4096:
            seen.append((xr75p.clone(), qss.clone(), is_short.clone(),
                         is_short_block.clone(), ST))
        return real(xr75p, qss, is_short, is_short_block, ST)

    loop._bits_at = record
    try:
        ctx["encode"](pcm, cfg, device="cuda")
    finally:
        loop._bits_at = real
    if not seen:
        fail("the main path made no 4096-lane bit evaluation")
    return seen[0]


def phase_bits_at(ctx, main_args):
    """Phase 3b: bits_at against bits_at_plain on the card; returns the
    JSON fields measured on the main path's own 4096-lane batch."""
    torch, k1, loop = ctx["torch"], ctx["k1"], ctx["loop"]
    from mp3tpu_torch.ops import bits_at as K
    from test_torch_bits_at_card import kernel_args, mismatches, random_batch
    mpeg = ctx["mpeg"]
    errs = []

    def check(label, args):
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

    def timed(label, args):
        """Kernel device and call time, the plain chain's device time,
        and K1's device time on the same quantized batch."""
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

    # the main path's widths, then wider batches (a corpus batches clips
    # as extra lanes): one granule a warp at G = 4096 fills one wave
    for G in (512, 4096, 4099, 16384, 65536):
        args = kernel_args(*random_batch(3030 + G, G), "cuda")
        check(f"random G={G}", args)
        timed(f"random G={G}", args)
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
    k_dev, p_dev, k1_dev, b_ms, b_by = timed("main path's batch", main_args)
    return dict(max_abs_err=max(errs), ms=k_dev, plain_ms=p_dev,
                k1_ms=k1_dev, bound_ms=b_ms, bound_by=b_by)


# (fixture, header mode: 3 mono / 0 stereo, kbps, rate) as in
# tests/test_fast_encoder.py
QUALITY = [
    ("sine_mono_64", 3, 64, 44100), ("noise_mono_64", 3, 64, 44100),
    ("sweep_st_128", 0, 128, 44100), ("noise_st_128", 0, 128, 44100),
    ("trans_st_128", 0, 128, 44100), ("sine_st_128_32k", 0, 128, 32000),
    ("q_sine_mono_64", 3, 64, 44100), ("q_sine_st_128", 0, 128, 44100),
    ("q_noise_st_128", 0, 128, 44100), ("q_sweep_st_128", 0, 128, 44100),
    ("q_trans_st_128", 0, 128, 44100), ("q_mix_st_128", 0, 128, 44100),
    ("q_mix_st_192", 0, 192, 44100), ("q_mix_mono_96_32k", 3, 96, 32000),
    ("q_mix_st_320_48k", 0, 320, 48000),
]


def check_grid(out, kbps, rate, nsamples):
    fsize = (144000 * kbps) // rate
    nframes = -(-nsamples // 1152)
    if len(out) != nframes * fsize + 1:
        fail(f"stream length {len(out)} != {nframes} frames x {fsize} + 1")
    for f in range(nframes):
        if out[f * fsize] != 0xFF or (out[f * fsize + 1] & 0xF0) != 0xF0:
            fail(f"frame {f}: no sync word at byte {f * fsize}")
    return fsize, nframes


def phase_quality(np, encode, EncoderConfig, decode_mp3, snr_db, read_wav):
    golden = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden, "ref_snr.json")) as f:
        ref = json.load(f)
    worst = None
    for name, mode, kbps, rate in QUALITY:
        pcm, r = read_wav(os.path.join(golden, f"{name}.wav"))
        cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        data = pcm[:, 0] if mode == 3 else pcm
        out = encode(data, cfg, device="cuda")
        check_grid(out, kbps, rate, pcm.shape[0])
        dec, drate = decode_mp3(out)
        if drate != rate:
            fail(f"{name}: decoded rate {drate} != {rate}")
        for c in range(min(dec.shape[1], pcm.shape[1])):
            snr = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
            if not np.isfinite(snr) or snr < ref[name][c]:
                fail(f"{name} ch{c}: decoded SNR {snr:.2f} dB below the "
                     f"reference bar {ref[name][c]} dB")
            margin = snr - ref[name][c]
            if worst is None or margin < worst[0]:
                worst = (margin, name, c, snr)
    print(f"quality: {len(QUALITY)} fixtures on the frame grid and at or "
          f"above their ref_snr.json bars; worst margin {worst[0]:+.2f} dB "
          f"({worst[1]} ch{worst[2]}: {worst[3]:.2f} dB)", flush=True)


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
    ctx["K"].bits_at.launches = 0
    ctx["k1"].hist_c1.launches = 0
    ctx["loop"].any_on_host.syncs = 0
    ctx["torch"].cuda.synchronize()


def read_counts(ctx, path):
    """{kernel: launches} since reset_counts; fails if the path launched
    bits_at no time."""
    counts = {"bits_at": ctx["K"].bits_at.launches,
              "hist_c1": ctx["k1"].hist_c1.launches}
    if counts["bits_at"] <= 0:
        fail(f"the {path} launched bits_at no time")
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


def phase_build(k1, K):
    """Phase 2: build both kernel libraries, one nvcc process each,
    started together; prints bits_at.cu's -Xptxas -v report."""
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
    """Phase 5: the bench clip with loop._bits_at swapped for the plain
    chain, for the K1 chain, and as the package runs it; the three
    streams must be equal.  Returns the package run's counts and
    measurements."""
    np, torch, loop, K = ctx["np"], ctx["torch"], ctx["loop"], ctx["K"]
    encode, decode_mp3, snr_db = (ctx["encode"], ctx["decode_mp3"],
                                  ctx["snr_db"])
    real = loop._bits_at

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

    def run(chain=None):
        if chain is None:
            return encode(pcm, cfg, device="cuda")
        loop._bits_at = chain
        try:
            return encode(pcm, cfg, device="cuda")
        finally:
            loop._bits_at = real

    out_plain = run(plain_chain)
    reset_counts(ctx)
    out_k1 = run(k1_chain)
    k1_chain_launches = ctx["k1"].hist_c1.launches
    if k1_chain_launches <= 0:
        fail("the K1 chain launched K1 no time")

    reset_counts(ctx)
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    launches = read_counts(ctx, "main path")
    syncs = loop.any_on_host.syncs
    if out != out_plain:
        fail(f"main path with bits_at ({len(out)} bytes) != with the plain "
             f"chain ({len(out_plain)} bytes)")
    if out != out_k1:
        fail(f"main path with bits_at ({len(out)} bytes) != with the K1 "
             f"chain ({len(out_k1)} bytes)")
    fsize, nframes = check_grid(out, 128, 44100, pcm.shape[0])
    from mp3tpu_torch.encoder import _plan_segments
    plan = _plan_segments(nframes * 2)
    print(f"main path: with loop._bits_at swapped for the plain chain, for "
          f"the K1 chain, and with bits_at: the same {len(out)} bytes",
          flush=True)
    print(f"main path (bits_at, first run): {first_s:.3f} s; launches per "
          f"encode {launches} (K1 chain: hist_c1 {k1_chain_launches}); "
          f"loop-exit host syncs {syncs}; {len(plan)} segments "
          f"{[(n_pad * 2) for _, _, n_pad in plan]} lanes (each adds 2 syncs: "
          f"scan input, result download)", flush=True)

    times = {"k1": [], "bits_at": []}
    for who in ("k1", "bits_at", "bits_at", "k1", "k1", "bits_at"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = run(k1_chain if who == "k1" else None)
        times[who].append(time.perf_counter() - t0)
        if out_t != out:
            fail(f"a timed encode ({who}) gave other bytes")
    wall = statistics.median(times["bits_at"])
    wall_k1 = statistics.median(times["k1"])
    print(f"main path: 60 s stereo 128 kbps in {wall:.3f} s median of "
          f"{TIMED_RUNS} ({', '.join(f'{t:.3f}' for t in times['bits_at'])} "
          f"s): {CLIP_SECONDS / wall:.2f}x real time on {line}; in turns with "
          f"the K1 chain: {wall_k1:.3f} s median "
          f"({', '.join(f'{t:.3f}' for t in times['k1'])} s), "
          f"{CLIP_SECONDS / wall_k1:.2f}x", flush=True)

    for who, chain, median in (("k1", k1_chain, wall_k1),
                               ("bits_at", None, wall)):
        for _ in range(3):      # the profiler now and then records none
            n, busy, pwall = profile_once(torch, lambda: run(chain))
            if n > 0:
                break
        else:
            fail(f"torch.profiler recorded no device event ({who})")
        print(f"torch.profiler over one encode ({who}): {n} device kernels "
              f"and copies; device busy {busy:.4f} s of a profiled wall of "
              f"{pwall:.4f} s, idle share {1.0 - busy / pwall:.3f} (against "
              f"the unprofiled median {median:.3f} s: "
              f"{1.0 - busy / median:.3f})", flush=True)

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
    return dict(launches=launches, k1_chain_launches=k1_chain_launches)


def main():
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
    from mp3tpu_torch.runtime.wav import read_wav
    from mp3tpu_torch.tables import mpeg

    phase_build(k1, K)
    kres = phase_kernel(k1, torch)

    ctx = dict(np=np, torch=torch, k1=k1, K=K, loop=loop,
               EncoderConfig=EncoderConfig, mpeg=mpeg,
               encode=encode_layer3_fast, decode_mp3=decode_mp3,
               snr_db=snr_db, read_wav=read_wav, make_signal=make_signal)

    def cfg_of():
        return EncoderConfig(layer=3, mode=mpeg.MODE_STEREO,
                             bitrate_kbps=128, sample_rate_hz=44100)

    # ---- the main path: 60 s stereo 44.1 kHz 128 kbps
    pcm = make_signal(CLIP_SECONDS, 44100)
    t0 = time.perf_counter()
    bres = phase_bits_at(ctx, capture_main_batch(ctx, pcm, cfg_of()))
    print(f"phase 3b bits_at: {time.perf_counter() - t0:.2f} s", flush=True)
    phase_quality(np, encode_layer3_fast, EncoderConfig, decode_mp3, snr_db,
                  read_wav)
    t0 = time.perf_counter()
    main_res = phase_main(ctx, pcm, cfg_of(), line)
    print(f"phase 5 main path: {time.perf_counter() - t0:.2f} s", flush=True)

    phases = [("6 LSF", lambda: phase_lsf(ctx)),
              ("7 streaming", lambda: phase_stream(ctx, pcm, cfg_of)),
              ("8 Layers I/II", lambda: phase_layer12(ctx)),
              ("9 CLI", lambda: phase_cli(ctx, pcm, cfg_of))]
    counts = {}
    for name, run in phases:
        t0 = time.perf_counter()
        counts[name] = run()
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)

    launches = main_res["launches"]

    def by_path(kernel):
        return {"main": launches[kernel], "lsf": counts["6 LSF"][kernel],
                "stream": counts["7 streaming"][kernel]}

    err, k_ms, p_ms, (b_ms, b_by) = kres[4096]
    print(json.dumps({"kernels": [
        {"name": "hist_c1", "route": "cuda",
         "source": "mp3tpu_torch/csrc/hist_c1.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["hist_c1"], "max_abs_err": err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "launches_by_path": dict(
             by_path("hist_c1"),
             main_k1_chain=main_res["k1_chain_launches"])},
        {"name": "bits_at", "route": "cuda",
         "source": "mp3tpu_torch/csrc/bits_at.cu",
         "replaces": "mp3tpu/ops/pallas_bits.py:69",
         "launches": launches["bits_at"], "max_abs_err": bres["max_abs_err"],
         "ms": bres["ms"], "plain_ms": bres["plain_ms"],
         "bound_ms": bres["bound_ms"], "bound_by": bres["bound_by"],
         "library_ms": None, "launches_by_path": by_path("bits_at")}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
