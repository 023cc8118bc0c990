#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mp3tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
  2. build K1 (mp3tpu_torch/csrc/hist_c1.cu) with nvcc, timed;
  3. K1 against its plain PyTorch version on the card, bit for bit, on
     random quantized batches at G = 512, 4096 (the main path's segment
     widths) and 4099, then both timed: device time per call from
     torch.profiler, and call time with CUDA events (median);
  4. the 15 quality fixtures of tests/test_fast_encoder.py through
     encode_layer3_fast(device="cuda"): frame grid and the reference
     encoder's decoded-SNR bars (in-repo decoder);
  5. the main path: the 60 s stereo 44.1 kHz 128 kbps clip of bench.py,
     one run with K1's launch count reset before and read after, then 3
     timed runs; the stream must sit on the frame grid and its first
     10 s must decode within 1 dB of the CPU path's 10 s encode.
Its last lines are a JSON object describing the kernels and then
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIP_SECONDS = 60.0
TIMED_RUNS = 3


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def device_ms(fn, reps=20):
    """Mean device milliseconds per fn() call: the summed time of the
    kernels it runs, read from torch.profiler (None if the profiler
    recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA)
    return us / 1000.0 / reps if us > 0 else None


def phase_kernel(k1, torch):
    """K1 vs its plain version at the main path's widths; returns
    {G: (max_abs_err, kernel_ms, plain_ms)}."""
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
        results[G] = (err, k_dev, p_dev)
    return results


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


def first_seconds_snr(np, out, pcm, fsize, seconds, decode_mp3, snr_db):
    nf = -(-int(seconds * 44100) // 1152)
    dec, _ = decode_mp3(out[:nf * fsize])
    return [float(snr_db(pcm[:nf * 1152, c].astype(np.float64), dec[:, c]))
            for c in range(pcm.shape[1])]


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
    import numpy as np

    import mp3tpu_torch  # noqa: F401  (TF32 off)
    from bench import make_signal
    from mp3tpu.config import EncoderConfig
    from mp3tpu.decoder import decode_mp3
    from mp3tpu.decoder.layer3 import snr_db
    from mp3tpu.runtime.wav import read_wav
    from mp3tpu.tables import mpeg
    from mp3tpu_torch.encoder import _plan_segments, encode_layer3_fast
    from mp3tpu_torch.ops import hist_c1 as k1
    from mp3tpu_torch.ops import loop

    t0 = time.perf_counter()
    lib = k1.build(force=True)
    print(f"build: {os.path.relpath(lib, ROOT)} from "
          f"{os.path.relpath(k1.SOURCE, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(k1.NVCC_FLAGS)})",
          flush=True)

    kres = phase_kernel(k1, torch)
    phase_quality(np, encode_layer3_fast, EncoderConfig, decode_mp3, snr_db,
                  read_wav)

    # ---- the main path: 60 s stereo 44.1 kHz 128 kbps
    pcm = make_signal(CLIP_SECONDS, 44100)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    k1.hist_c1.launches = 0
    loop.any_on_host.syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = encode_layer3_fast(pcm, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    launches = k1.hist_c1.launches
    syncs = loop.any_on_host.syncs
    if launches <= 0:
        fail("the main path launched K1 no time")
    fsize, nframes = check_grid(out, 128, 44100, pcm.shape[0])
    plan = _plan_segments(nframes * 2)
    print(f"main path (first run, incl. warm-up): {first_s:.3f} s; "
          f"K1 launches {launches}; loop-exit host syncs {syncs}; "
          f"{len(plan)} segments {[(n_pad * 2) for _, _, n_pad in plan]} "
          f"lanes (each adds 2 syncs: scan input, result download)",
          flush=True)
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_t = encode_layer3_fast(pcm, cfg, device="cuda")
        times.append(time.perf_counter() - t0)
        check_grid(out_t, 128, 44100, pcm.shape[0])
    wall = statistics.median(times)
    print(f"main path: 60 s stereo 128 kbps in {wall:.3f} s median of "
          f"{TIMED_RUNS} ({', '.join(f'{t:.3f}' for t in times)} s): "
          f"{CLIP_SECONDS / wall:.2f}x real time on {line}", flush=True)

    snr_gpu = first_seconds_snr(np, out, pcm, fsize, 10.0, decode_mp3,
                                snr_db)
    short = pcm[:int(10.0 * 44100)]
    out_cpu = encode_layer3_fast(short, cfg, device="cpu")
    snr_cpu = first_seconds_snr(np, out_cpu, short, fsize, 10.0, decode_mp3,
                                snr_db)
    print(f"decoded SNR of the first 10 s: cuda {snr_gpu} dB, cpu path "
          f"{snr_cpu} dB", flush=True)
    for g, c in zip(snr_gpu, snr_cpu):
        if not np.isfinite(g) or g < c - 1.0:
            fail(f"first-10 s SNR {g:.2f} dB is more than 1 dB below the "
                 f"CPU path's {c:.2f} dB")

    err, k_ms, p_ms = kres[4096]
    print(json.dumps({"kernels": [{
        "name": "hist_c1", "route": "cuda",
        "source": "mp3tpu_torch/csrc/hist_c1.cu",
        "replaces": "mp3tpu/ops/pallas_bits.py:69",
        "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
