"""Psychoacoustic model 2, Layer I/II flavour (psy.c:37-421), batched.

Outputs the 32 per-subband SNR values used by the Layer I/II bit
allocation.  Stateless reformulation over the frame axis (the
reference's carried state becomes indexing):

  savebuf slide (psy.c:258-267): for layer 2, iteration i of frame f
    windows stream[1152 f + 576 i - 480 : +1024); for layer 1, frame f
    windows stream[384 f - 640 : +1024) -- including get_audio's
    64-sample look-back (encode.c:221-246), the layer-1 psy input is
    just the contiguous stream.  Zero-padded before t=0.
  r/phi two-window history (psy.c:276-291): per channel, the
    new/old/oldest rotation reduces to shifts of the window sequence
    (2 toggles per channel call for layer 2, 1 per frame for layer 1;
    parity is identical every frame, so slot `old` always holds the
    previous window and `oldest` the one before).
  lthr pre-echo memory, layer 1 only (psy.c:355-363): shift of the
    per-frame preliminary threshold.

float32 rounding points follow the reference's FLOAT buffers
(grouped_e/c, ecb/cb, nb/bc, fthr/lthr, s, cbval, rnorm are float;
tb/temp* are double).
"""
import numpy as np

from . import fft32
from ..tables import mpeg

F = np.float32
LN = mpeg.LN_TO_LOG10
CBANDS = 63
HBLKSIZE = 513
BLKSIZE = 1024
LXMIN = 32.0
_NMT = 5.5

_CRIT_BAND = np.array([0, 100, 200, 300, 400, 510, 630, 770, 920, 1080,
                       1270, 1480, 1720, 2000, 2320, 2700, 3150, 3700,
                       4400, 5300, 6400, 7700, 9500, 12000, 15500, 25000,
                       30000], np.float64)
_BMAX = np.array([20.0, 20.0, 20.0, 20.0, 20.0, 17.0, 15.0, 10.0, 7.0,
                  4.4, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5, 4.5,
                  4.5, 4.5, 4.5, 4.5, 3.5, 3.5, 3.5], np.float64)

_PARAM_CACHE = {}


def _init_params(sfreq):
    """psy.c:129-241 init: partitions, spreading matrix, tmn, rnorm."""
    key = float(sfreq)
    if key in _PARAM_CACHE:
        return _PARAM_CACHE[key]
    import os

    from ..tables import psy as psytab
    _D = np.load(os.path.join(os.path.dirname(psytab.__file__), "data",
                              "iso_tables.npz"))

    freq_mult = sfreq / BLKSIZE
    # bark value of each line (fthr as temp storage, float32 array)
    fthr = np.zeros(HBLKSIZE, F)
    for i in range(HBLKSIZE):
        temp1 = i * freq_mult
        j = 1
        while temp1 > _CRIT_BAND[j]:
            j += 1
        fthr[i] = F(j - 1 + (temp1 - _CRIT_BAND[j - 1])
                    / (_CRIT_BAND[j] - _CRIT_BAND[j - 1]))
    partition = np.zeros(HBLKSIZE, np.int64)
    cbval = np.zeros(CBANDS, F)
    numlines = np.zeros(CBANDS, np.int64)
    # 0.33-bark partitioning (psy.c:186-207); all arithmetic on f32
    # values promoted to double like the C expressions
    count = 1
    cbval[0] = fthr[0]
    bval_lo = float(fthr[0])
    for i in range(1, HBLKSIZE):
        if (float(fthr[i]) - bval_lo) > 0.33:
            partition[i] = partition[i - 1] + 1
            cbval[partition[i - 1]] = F(float(cbval[partition[i - 1]]) / count)
            cbval[partition[i]] = fthr[i]
            bval_lo = float(fthr[i])
            numlines[partition[i - 1]] = count
            count = 1
        else:
            partition[i] = partition[i - 1]
            cbval[partition[i]] = F(float(cbval[partition[i]]) + float(fthr[i]))
            count += 1
    numlines[partition[HBLKSIZE - 1]] = count
    cbval[partition[HBLKSIZE - 1]] = F(
        float(cbval[partition[HBLKSIZE - 1]]) / count)

    # spreading function s[target][source] (psy.c:213-228)
    s = np.zeros((CBANDS, CBANDS), F)
    cb64 = cbval.astype(np.float64)
    for j in range(CBANDS):
        for i in range(CBANDS):
            t1 = (cb64[i] - cb64[j]) * 1.05
            if 0.5 <= t1 <= 2.5:
                t2 = t1 - 0.5
                t2 = 8.0 * (t2 * t2 - 2.0 * t2)
            else:
                t2 = 0.0
            t1 += 0.474
            t3 = 15.811389 + 7.5 * t1 - 17.5 * np.sqrt(1.0 + t1 * t1)
            if t3 <= -100.0:
                s[i, j] = 0.0
            else:
                s[i, j] = F(np.exp((t2 + t3) * LN))

    tmn = np.maximum(15.5 + cb64, 24.5)
    rnorm = np.zeros(CBANDS, F)
    for j in range(CBANDS):
        acc = F(0.0)
        for i in range(CBANDS):
            acc = F(float(acc) + float(s[j, i]))
        rnorm[j] = acc

    if key in (32000.0, 44100.0, 48000.0):
        sfreq_idx = {32000.0: 0, 44100.0: 1, 48000.0: 2}[key]
        absthr = _D[f"absthr_{sfreq_idx}"].astype(np.float64)
    else:
        # MPEG-2 LSF rate (16/22.05/24 kHz): the reference ships no
        # absolute-threshold tables for these -- psy.c:136 rejects the
        # rates outright, making LSF L1/L2 dead code there.  Each LSF
        # rate is exactly half an MPEG-1 rate, so LSF line i sits at
        # the parent's line-i/2 frequency with HALF the line width:
        # threshold mass per line halves (same rule tables/psy.py
        # _lsf_params applies to the Layer III qthr tables).
        parent_idx = {16000.0: 0, 22050.0: 1, 24000.0: 2}[key]
        parent = _D[f"absthr_{parent_idx}"].astype(np.float64)
        absthr = parent[np.arange(HBLKSIZE) // 2] * 0.5
    P = dict(partition=partition, cbval=cbval, numlines=numlines, s=s,
             tmn=tmn, rnorm=rnorm, absthr=absthr)
    _PARAM_CACHE[key] = P
    return P


def _window_energies(stream, starts, sfreq):
    """FFT energy/phi for 1024-sample windows at the given start
    offsets (zero-padded before t=0), float32 Hann + rsfft."""
    i = np.arange(BLKSIZE, dtype=np.float64)
    window = (0.5 * (1 - np.cos(2.0 * mpeg.REF_PI * (i - 0.5) / BLKSIZE))
              ).astype(F)
    pad = BLKSIZE
    xp = np.concatenate([np.zeros(pad), np.asarray(stream, np.float64)])
    idx = pad + starts[:, None] + np.arange(BLKSIZE)[None, :]
    idx = np.clip(idx, 0, len(xp) - 1)
    valid = (pad + starts[:, None] + np.arange(BLKSIZE)[None, :]) >= 0
    frames = np.where(valid, xp[idx], 0.0).astype(F) * window[None, :]
    return fft32.energy_phi(fft32.rsfft(frames))


def snr32_frames(stream, layer, sfreq):
    """Model-2 SNR for every frame of one channel.

    stream: int16-valued 1-D array for the channel (raw PCM).
    layer: 1 or 2.  sfreq: sample rate in Hz.
    Returns (nframes, 32) float64 (`ltmin` values, musicin.c:681-686).
    """
    P = _init_params(float(sfreq))
    stream = np.asarray(stream, np.float64)
    if layer == 1:
        spf = 384
        nframes = len(stream) // spf
        starts = 384 * np.arange(nframes) - 640
        W = 1  # windows per frame
    else:
        spf = 1152
        nframes = len(stream) // spf
        f = np.repeat(np.arange(nframes), 2)
        i = np.tile(np.arange(2), nframes)
        starts = 1152 * f + 576 * i - 480
        W = 2
    energy, phi = _window_energies(stream, starts, sfreq)
    NW = len(starts)

    # unpredictability (psy.c:283-291): r is FLOAT, phi FLOAT
    r = np.sqrt(energy.astype(np.float64)).astype(F).astype(np.float64)
    r1 = np.concatenate([np.zeros((1, HBLKSIZE)), r[:-1]])
    r2 = np.concatenate([np.zeros((2, HBLKSIZE)), r[:-2]])
    phi64 = phi.astype(np.float64)
    p1 = np.concatenate([np.zeros((1, HBLKSIZE)), phi64[:-1]])
    p2 = np.concatenate([np.zeros((2, HBLKSIZE)), phi64[:-2]])
    # r_prime/phi_prime are FLOAT scalars: double expression, one
    # rounding on store (psy.c:283-284)
    rp = (2.0 * r1 - r2).astype(F).astype(np.float64)
    pp = (2.0 * p1 - p2).astype(F).astype(np.float64)
    t1 = r * np.cos(phi64) - rp * np.cos(pp)
    t2 = r * np.sin(phi64) - rp * np.sin(pp)
    t3 = (r + np.abs(rp)).astype(np.float64)
    c = np.where(t3 != 0.0,
                 np.sqrt(t1 * t1 + t2 * t2) / np.where(t3 == 0, 1, t3),
                 0.0).astype(F).astype(np.float64)

    # grouped energies (psy.c:297-309); grouped_e/c are FLOAT buffers
    part = P["partition"]
    en64 = energy.astype(np.float64)
    ge = np.zeros((NW, CBANDS), F)
    gc = np.zeros((NW, CBANDS), F)
    ge[:, 0] = energy[:, 0]
    gc[:, 0] = (en64[:, 0] * c[:, 0]).astype(F)
    prod = en64 * c
    for j in range(1, HBLKSIZE):
        tp = part[j]
        ge[:, tp] = (ge[:, tp].astype(np.float64) + en64[:, j]).astype(F)
        gc[:, tp] = (gc[:, tp].astype(np.float64) + prod[:, j]).astype(F)

    # spreading convolution (psy.c:315-327); ecb/cb FLOAT
    s = P["s"].astype(np.float64)
    ecb = np.zeros((NW, CBANDS), F)
    cb = np.zeros((NW, CBANDS), F)
    ge64 = ge.astype(np.float64)
    gc64 = gc.astype(np.float64)
    for k in range(CBANDS):
        nz = s[:, k] != 0.0
        upd = ecb[:, nz].astype(np.float64) + s[nz, k][None, :] * ge64[:, k:k + 1]
        ecb[:, nz] = upd.astype(F)
        upd = cb[:, nz].astype(np.float64) + s[nz, k][None, :] * gc64[:, k:k + 1]
        cb[:, nz] = upd.astype(F)
    ecb64 = ecb.astype(np.float64)
    cbn = np.where(ecb64 != 0.0,
                   cb.astype(np.float64) / np.where(ecb64 == 0, 1, ecb64),
                   0.0).astype(F).astype(np.float64)

    # tonality -> required SNR -> permissible noise (psy.c:333-347)
    cbn = np.clip(cbn, 0.05, 0.5)
    tb = -0.434294482 * np.log(cbn) - 0.301029996
    bc = P["tmn"][None, :] * tb + _NMT * (1.0 - tb)
    kk = (P["cbval"].astype(np.float64) + 0.5).astype(np.int64)
    bc = np.maximum(bc, _BMAX[kk][None, :])
    bc = np.exp(-bc * LN).astype(F).astype(np.float64)

    denom = (P["rnorm"].astype(np.float64) * P["numlines"])
    nb = np.where(denom[None, :] != 0.0,
                  ecb64 * bc / np.where(denom == 0, 1, denom)[None, :],
                  0.0).astype(F).astype(np.float64)

    # line thresholds + layer-1 pre-echo (psy.c:353-364); fthr FLOAT
    temp1 = np.maximum(nb[:, part], P["absthr"][None, :])
    if layer == 1:
        lthr_prev = np.concatenate(
            [np.full((1, HBLKSIZE), F(60802371420160.0), np.float64),
             (LXMIN * temp1[:-1]).astype(F).astype(np.float64)])
        fthr = np.minimum(temp1, lthr_prev).astype(F).astype(np.float64)
        fthr = np.maximum(temp1 * 0.00316, fthr
                          ).astype(F).astype(np.float64)
    else:
        fthr = temp1.astype(F).astype(np.float64)

    # translate to the 32 subbands (psy.c:369-387)
    # minthres/sum_energy are FLOAT scalars accumulated over 17 lines
    # ascending (psy.c:369-387)
    def _f32sum(seg):
        acc = np.zeros(seg.shape[0], F)
        for k in range(seg.shape[1]):
            acc = (acc.astype(np.float64) + seg[:, k]).astype(F)
        return acc.astype(np.float64)

    snrtmp = np.zeros((NW, 32))
    for j in range(0, 193, 16):
        minthres = fthr[:, j:j + 17].astype(F).min(axis=1).astype(np.float64)
        sume = _f32sum(en64[:, j:j + 17])
        v = (sume / (minthres * 17.0)).astype(F).astype(np.float64)
        snrtmp[:, j // 16] = (4.342944819 * np.log(v)).astype(F)
    for j in range(208, HBLKSIZE - 1, 16):
        sumt = _f32sum(fthr[:, j:j + 17])
        sume = _f32sum(en64[:, j:j + 17])
        v = (sume / sumt).astype(F).astype(np.float64)
        snrtmp[:, j // 16] = (4.342944819 * np.log(v)).astype(F)

    if layer == 2:
        snr = np.maximum(snrtmp[0::2], snrtmp[1::2]).astype(F)
    else:
        snr = snrtmp.astype(F)
    return snr.astype(np.float64)
