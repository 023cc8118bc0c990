"""Decoded-SNR quality gate on the device (counterpart of
``tools/quality_tpu.py``).

Encodes the 15 fixtures of ``tests/test_fast_encoder.py`` with
``encode_layer3_fast`` on the device, checks each stream against the CBR
frame grid (length and a sync word at every frame start), decodes it on
the host with the in-repo decoder and holds each channel's decoded SNR
to the reference encoder's bar (``tests/golden/ref_snr.json``).  When
libmpg123 is present each stream is also decoded by it, the independent
decoder, and its best-lag SNR is reported.

    python -m mp3tpu_torch.tools.quality [--device cuda|cpu]
        [--fixtures NAME ...] [out.json]

Prints the report (the JAX tool's keys; ``backend`` and ``device`` from
torch, ``device`` the card's name and power limit) as JSON on stdout,
one line per fixture on stderr; writes ``out.json`` only when given.
Exits 1 if any fixture misses its bar.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from ..config import EncoderConfig
from ..decoder import decode_mp3
from ..decoder.layer3 import snr_db
from ..encoder import encode_layer3_fast
from ..runtime import mpg123
from ..runtime.wav import read_wav
from ..tables import mpeg
from . import describe, device_or_exit

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")

#: (fixture, mode, kbps, rate) as in tests/test_fast_encoder.py
CASES = [
    ("sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("noise_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("sweep_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("noise_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("trans_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("sine_st_128_32k", mpeg.MODE_STEREO, 128, 32000),
    ("q_sine_mono_64", mpeg.MODE_MONO, 64, 44100),
    ("q_sine_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_noise_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_sweep_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_trans_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_mix_st_128", mpeg.MODE_STEREO, 128, 44100),
    ("q_mix_st_192", mpeg.MODE_STEREO, 192, 44100),
    ("q_mix_mono_96_32k", mpeg.MODE_MONO, 96, 32000),
    ("q_mix_st_320_48k", mpeg.MODE_STEREO, 320, 48000),
]


def best_lag_snr(ref, dec, max_lag=2000, min_len=1000):
    """max over lags L < max_lag of the SNR of ref[:n] against
    dec[L:L+n], n = min(len(ref), len(dec) - L) >= min_len (decoders
    differ in their delay); -99.0 when no lag qualifies.

    The definition of ``tests/test_conformance.py``'s loop, evaluated
    for every lag at once through one FFT cross-correlation and prefix
    sums, then recomputed directly at the three best lags."""
    ref = np.asarray(ref, np.float64)
    dec = np.asarray(dec, np.float64)
    lags = np.arange(max_lag)
    n = np.minimum(len(ref), len(dec) - lags)
    lags, n = lags[n >= min_len], n[n >= min_len]
    if not len(lags):
        return -99.0
    size = 1 << int(np.ceil(np.log2(len(ref) + len(dec))))
    # cross[L] = sum_i ref[i] dec[L + i]; dec ends at its length, so the
    # sum stops at i < len(dec) - L by itself
    cross = np.fft.irfft(np.conj(np.fft.rfft(ref, size))
                         * np.fft.rfft(dec, size), size)[lags]
    r2 = np.concatenate([[0.0], np.cumsum(ref ** 2)])
    d2 = np.concatenate([[0.0], np.cumsum(dec ** 2)])
    err = r2[n] - 2.0 * cross + d2[lags + n] - d2[lags]
    approx = r2[n] / np.maximum(err, 1e-30)
    best = -99.0
    for k in np.argsort(approx)[-3:]:
        o = ref[:n[k]]
        e = o - dec[lags[k]:lags[k] + n[k]]
        best = max(best, float(10 * np.log10(
            (o ** 2).sum() / max((e ** 2).sum(), 1e-30))))
    return best


def _mpg123_snr(out, pcm, rate, nch):
    """Cross-decode with the system libmpg123 (independent decoder);
    per-channel best-lag SNR, or None if unavailable."""
    if not mpg123.available():
        return None
    try:
        dec, drate = mpg123.decode(out)
    except RuntimeError as e:
        return {"error": str(e)}
    if drate != rate:
        return {"error": f"rate {drate} != {rate}"}
    return [round(best_lag_snr(pcm[:, c], dec[:, c]), 2)
            for c in range(min(nch, dec.shape[1]))]


def on_grid(out, kbps, rate, nsamples):
    """Length = frames x frame size + 1 and a sync word at every frame
    start."""
    fsize = (144000 * kbps) // rate
    nframes = -(-nsamples // 1152)
    return len(out) == nframes * fsize + 1 and all(
        out[f * fsize] == 0xFF and (out[f * fsize + 1] & 0xF0) == 0xF0
        for f in range(nframes))


def run(names, device):
    """The report for the fixtures `names` encoded on `device`."""
    dev = torch.device(device)
    with open(os.path.join(GOLDEN, "ref_snr.json")) as f:
        ref = json.load(f)
    cases = {c[0]: c for c in CASES}
    report = {"backend": dev.type, "device": describe(dev),
              "x64": torch.get_default_dtype() == torch.float64,
              "fixtures": {}, "all_pass": True}
    for name in names:
        _, mode, kbps, rate = cases[name]
        pcm, _ = read_wav(os.path.join(GOLDEN, f"{name}.wav"))
        cfg = EncoderConfig(layer=3, mode=mode, bitrate_kbps=kbps,
                            sample_rate_hz=rate)
        data = pcm[:, 0] if mode == mpeg.MODE_MONO else pcm
        out = encode_layer3_fast(data, cfg, device=dev)
        ok_struct = on_grid(out, kbps, rate, pcm.shape[0])
        dec, drate = decode_mp3(out)
        chans = []
        ok = ok_struct and drate == rate
        for c in range(min(dec.shape[1], pcm.shape[1])):
            snr = float(snr_db(pcm[:, c].astype(np.float64), dec[:, c]))
            bar = ref[name][c]
            chans.append({"snr_db": round(snr, 2), "ref_bar_db": bar,
                          "margin_db": round(snr - bar, 2)})
            ok = ok and snr >= bar
        report["fixtures"][name] = {"pass": ok, "channels": chans,
                                    "valid_cbr_grid": ok_struct,
                                    "mpg123_snr_db": _mpg123_snr(
                                        out, pcm, rate, pcm.shape[1])}
        report["all_pass"] = report["all_pass"] and ok
        print(f"{name:20s} {'PASS' if ok else 'FAIL'} "
              + " ".join(f"{c['snr_db']:.1f}>={c['ref_bar_db']}"
                         for c in chans), file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mp3tpu_torch.tools.quality",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixtures", nargs="+", choices=[c[0] for c in CASES],
                    default=[c[0] for c in CASES])
    ap.add_argument("out", nargs="?", help="also write the report here")
    args = ap.parse_args(argv)
    dev = device_or_exit("quality", args.device)
    report = run(args.fixtures, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
