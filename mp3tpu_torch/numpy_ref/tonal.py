"""Psychoacoustic model 1 (tonal.c), reimplemented from the ISO
11172-3 Annex D algorithm.

The reference distribution is BROKEN for model 1: it reads the Annex D
frequency/critical-band tables from external files ('1cb0', '2th1',
...) that were never compiled in (tonal.c:97,128; common.c:158-202) --
running `-p 1` exits with "Please check 1cb0 boundary table".  This
module therefore regenerates the tables from the normative formulas
(bark scale and absolute threshold in quiet) and implements the
algorithm faithfully from tonal.c:

  windowed FFT power spectrum, +96 dB normalization  (tonal.c:180-262)
  per-subband spectral maxima ("spike")              (tonal.c:296-310)
  tonal component labeling (local maxima, -7 dB
    neighborhood test, component merging)            (tonal.c:332-405)
  noise components per critical band (geometric-mean
    center line)                                     (tonal.c:407-475)
  decimation below the hearing threshold and within
    0.5 bark                                         (tonal.c:484-535)
  individual masking thresholds with the two-slope
    spreading function vf, tonal/noise masking
    indices, global threshold LTg                    (tonal.c:545-590)
  per-subband minimum threshold and SMR              (tonal.c:598-648)

Tables: entries subsample the spectrum like the Annex D tables (every
line to 48, every 2nd to 96, every 4th to 192, every 8th above);
bark z(f) = 13 atan(.00076 f) + 3.5 atan((f/7500)^2) and threshold in
quiet LTq(f) = 3.64 (f/kHz)^-.8 - 6.5 exp(-.6 (f/kHz-3.3)^2)
+ 1e-3 (f/kHz)^4, both normative.
"""
import numpy as np

from ..tables import mpeg

POWERNORM = 90.3090
DBMIN = -200.0
_TABLE_CACHE = {}


def _bark(f):
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _ltq(f):
    khz = np.maximum(f, 20.0) / 1000.0
    return (3.64 * khz ** -0.8 - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 1e-3 * khz ** 4)


def model1_tables(layer, sfreq_hz):
    """(ltg_line, ltg_bark, ltg_hear, cbound) for layer 1/2 at a rate.

    ltg arrays have a dummy entry 0 (tonal.c:136-138); cbound holds
    critical-band boundary line indices.
    """
    key = (layer, float(sfreq_hz))
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    fft = 512 if layer == 1 else 1024
    nlines = fft // 2
    binw = sfreq_hz / fft
    # Annex-D-style subsampling of line indices
    lines = (list(range(1, min(49, nlines)))
             + list(range(50, min(97, nlines), 2))
             + list(range(100, min(193, nlines), 4))
             + list(range(200, nlines, 8)))
    # keep lines below 20 kHz (beyond is above the coding band)
    lines = [l for l in lines if l * binw < 20000.0]
    f = np.array(lines) * binw
    ltg_line = np.concatenate([[0], lines]).astype(np.int64)
    ltg_bark = np.concatenate([[0.0], _bark(f)])
    ltg_hear = np.concatenate([[0.0], _ltq(f)])
    # critical band boundaries: first line in each integer bark band
    zl = _bark(np.arange(nlines) * binw)
    nbark = int(np.floor(zl[-1])) + 1
    cb = [1]
    for z in range(1, nbark + 1):
        idx = np.searchsorted(zl, float(z))
        if idx >= nlines:
            break
        if idx > cb[-1]:
            cb.append(int(idx))
    cb.append(nlines - 1)
    cbound = np.array(cb, np.int64)
    out = (ltg_line, ltg_bark, ltg_hear, cbound)
    _TABLE_CACHE[key] = out
    return out


def _add_db(a, b):
    return 10.0 * np.log10(10.0 ** (a / 10.0) + 10.0 ** (b / 10.0))


def _analyze_window(sample, layer, ltg_line, ltg_bark, ltg_hear, cbound,
                    line_map, bitrate_per_ch, sblimit):
    """One channel window -> (spike[32], ltmin[32])."""
    fft = 512 if layer == 1 else 1024
    nlines = fft // 2
    win = np.sqrt(8.0 / 3.0) * 0.5 * (
        1 - np.cos(2.0 * np.pi * np.arange(fft) / fft)) / fft
    spec = np.fft.rfft(sample * win)[:nlines]
    energy = np.maximum(np.abs(spec) ** 2, 1e-20)
    x = 10.0 * np.log10(energy) + POWERNORM
    sub_size = len(ltg_line)

    # spike: per-subband spectral maximum (tonal.c:296-310)
    per = nlines // 32
    spike = x.reshape(32, per).max(axis=1)

    # tonal labeling (tonal.c:332-405)
    x = x.copy()
    is_tone = np.zeros(nlines, bool)
    cand = [i for i in range(2, nlines - (6 if layer == 1 else 12))
            if x[i] > x[i - 1] and x[i] >= x[i + 1]]
    tones = []
    top = 250 if layer == 1 else 500
    for i in cand:
        if i < 3 or i > top:
            run = 0
        elif i < 63:
            run = 2
        elif i < 127:
            run = 3
        elif layer == 2 and i < 255:
            run = 6
        else:
            run = 6 if layer == 1 else 12
        ok = True
        for j in range(2, run + 1):
            if x[i] - 7 < x[i - j] or x[i] - 7 < x[i + j]:
                ok = False
                break
        if not ok:
            continue
        if 1 < i < (255 if layer == 1 else 500):
            x[i] = _add_db(x[i], _add_db(x[i - 1], x[i + 1]))
        for j in range(1, run + 1):
            x[i - j] = x[i + j] = DBMIN
        is_tone[i] = True
        tones.append(i)

    # noise components per critical band (tonal.c:407-475, geometric
    # mean center, non-MAKE_SENSE branch)
    noises = []
    for b in range(len(cbound) - 1):
        lo, hi = int(cbound[b]), int(cbound[b + 1])
        sum_db = DBMIN
        for j in range(lo, hi):
            if not is_tone[j] and x[j] != DBMIN:
                sum_db = _add_db(x[j], sum_db)
                x[j] = DBMIN
        centre = int(np.sqrt(float(lo) * float(hi - 1)) + 0.5)
        if centre < nlines and is_tone[centre]:
            centre += 1 if centre + 1 < nlines and is_tone[
                min(centre + 1, nlines - 1)] else -1
        centre = min(max(centre, 0), nlines - 1)
        x[centre] = sum_db
        noises.append(centre)

    # decimation (tonal.c:484-535)
    tones = [t for t in tones if x[t] >= ltg_hear[line_map[t]]]
    noises = [n for n in noises if x[n] >= ltg_hear[line_map[n]]]
    pruned = []
    for t in tones:
        if pruned and ltg_bark[line_map[t]] - ltg_bark[line_map[pruned[-1]]] < 0.5:
            if x[t] > x[pruned[-1]]:
                pruned[-1] = t
        else:
            pruned.append(t)
    tones = pruned

    # global threshold (tonal.c:545-590)
    ltg_x = np.full(sub_size, DBMIN)
    zk = ltg_bark[1:]                      # (sub_size-1,)
    for comps, c1, c2 in ((tones, 0.275, 4.5), (noises, 0.175, 0.5)):
        for t in comps:
            zt = ltg_bark[line_map[t]]
            dz = zk - zt
            m = (dz >= -3.0) & (dz < 8.0)
            if not m.any():
                continue
            tmps = -1.525 - c1 * zt - c2 + x[t]
            vf = np.where(dz < -1, 17.0 * (dz + 1) - (0.4 * x[t] + 6.0),
                 np.where(dz < 0, (0.4 * x[t] + 6.0) * dz,
                 np.where(dz < 1, -17.0 * dz,
                          -(dz - 1) * (17.0 - 0.15 * x[t]) - 17.0)))
            upd = tmps + vf
            cur = ltg_x[1:]
            ltg_x[1:] = np.where(m, 10.0 * np.log10(
                10.0 ** (cur / 10.0) + 10.0 ** (upd / 10.0)), cur)
    offs = 0.0 if bitrate_per_ch < 96 else -12.0
    ltg_x[1:] = 10.0 * np.log10(10.0 ** ((ltg_hear[1:] + offs) / 10.0)
                                + 10.0 ** (ltg_x[1:] / 10.0))

    # per-subband minimum threshold (tonal.c:598-621)
    shift = 3 if layer == 1 else 4
    ltmin = np.empty(32)
    j = 1
    for sb in range(32):
        if j >= sub_size - 1:
            ltmin[sb] = ltg_hear[sub_size - 1]
            continue
        mn = ltg_x[j]
        while j < sub_size and (ltg_line[j] >> shift) == sb:
            mn = min(mn, ltg_x[j])
            j += 1
        ltmin[sb] = mn
    return spike, ltmin


def psycho_one_frames(pcm, layer, cfg, sb_all):
    """Model-1 SMR for all frames.

    pcm: (nch, nsamples) int16-valued; sb_all: (nch, F, G, 12, 32)
    subband samples (for the per-frame scale factors the SMR uses).
    Returns (nch, F, 32) SMR values (`ltmin` outputs, tonal.c:625-648).
    """
    nch = pcm.shape[0]
    spf = 384 if layer == 1 else 1152
    F = sb_all.shape[1]
    sfreq = cfg.sample_rate_hz
    ltg_line, ltg_bark, ltg_hear, cbound = model1_tables(layer, sfreq)
    fft = 512 if layer == 1 else 1024
    nlines = fft // 2
    # map every line to its ltg entry (make_map, tonal.c:153-161)
    line_map = np.zeros(nlines, np.int64)
    for i in range(1, len(ltg_line)):
        line_map[ltg_line[i - 1]:ltg_line[i] + 1] = i
    line_map[ltg_line[-1]:] = len(ltg_line) - 1

    bitrate_per_ch = cfg.bitrate_kbps // nch
    sblimit = 32
    smr = np.zeros((nch, F, 32))
    pad = np.concatenate([np.zeros((nch, 192)), pcm / 32768.0], axis=1)
    for f in range(F):
        # window = stream[spf*f - 192 : +fft) (tonal.c:686-689, 1013-1016)
        seg = pad[:, spf * f: spf * f + fft]
        if seg.shape[1] < fft:
            seg = np.pad(seg, ((0, 0), (0, fft - seg.shape[1])))
        for ch in range(nch):
            spike, ltmin = _analyze_window(
                seg[ch], layer, ltg_line, ltg_bark, ltg_hear, cbound,
                line_map, bitrate_per_ch, sblimit)
            # scale factor per subband: min over groups of the max
            # sample (pick_scale / put_scale semantics)
            peak = np.abs(sb_all[ch, f]).max(axis=(0, 1))
            mult = mpeg.MULTIPLE[:63]
            idx = np.clip(np.searchsorted(-mult, -peak, side="right") - 1,
                          0, 62)
            scale = mult[idx]
            lvl = 20.0 * np.log10(np.maximum(scale * 32768.0, 1e-9)) - 10.0
            smr[ch, f] = np.maximum(lvl, spike) - ltmin
    return smr
