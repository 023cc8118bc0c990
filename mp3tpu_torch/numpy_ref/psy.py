"""Psychoacoustic model 2, Layer III flavour (l3psy.c:443-740), batched.

Stateless reformulation over the granule axis.  All reference carried
state becomes indexing:

  savebuf slide (l3psy.c:477-481): granule g's long FFT window is
    stream[576 g - 768 : 576 g + 256), zero-padded before t=0;
  r/phi two-granule history (l3psy.c:496-512): shifts of per-granule
    spectra;
  nb_1/nb_2 pre-echo memory (l3psy.c:629-636): shifts of raw nb;
  blocktype FSM + one-granule emission delay (l3psy.c:647-733):
    a tiny sequential scan over {NORM, SHORT, STOP} with
      state' = attack ? SHORT : (state==SHORT ? STOP : NORM)
      emit   = attack ? (state==NORM ? START : SHORT) : state
  ratio emission delay (l3psy.c:452-456): output[g] = computed[g-1].

FFT precision follows the reference: the split-radix FFT runs in
float32 (subs.c FLOAT), with the energy floor of 0.0005 on interior
lines and zeroed phase there (subs.c:67-122).  The unpredictability
measure is invariant to the FFT's phase sign convention, so np.fft is a
valid stand-in for Malvar's packing.
"""
import numpy as np

from . import fft32
from ..tables import mpeg
from ..tables.psy import (CBANDS, CBANDS_S, HBLKSIZE, HBLKSIZE_S, SBMAX_L,
                          SBMAX_S, S3IND, psy_params_for_sfreq)

LN = mpeg.LN_TO_LOG10
SWITCH_PE = 1800.0


def _hann(n):
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1 - np.cos(2.0 * mpeg.REF_PI * (i - 0.5) / n))).astype(np.float32)


def _fft_energy_phi(frames_f32):
    """energy/phi, bit-exact float32 split-radix path (see fft32)."""
    return fft32.energy_phi(fft32.rsfft(frames_f32))


def psycho_granules(samples, sfreq_hz):
    """Run model 2 over all granules of one channel.

    samples: int16-valued float/int array, one channel, length 576*G
             (the raw PCM, *not* scaled).
    Returns dict with per-granule emitted outputs (already one-granule
    delayed exactly like the reference):
      block_type (G,), ratio_l (G,21), ratio_s (G,12,3), pe (G,)
    """
    P = psy_params_for_sfreq(float(sfreq_hz))
    s = np.asarray(samples, np.float64)
    G = len(s) // 576
    s = s[:576 * G]

    win_l = _hann(1024)
    win_s = _hann(256)

    # --- long FFT windows: stream[576g-768 : 576g+256)
    pad = np.concatenate([np.zeros(768), s])
    idx = 576 * np.arange(G)[:, None] + np.arange(1024)[None, :]
    frames = (pad[idx]).astype(np.float32) * win_l[None, :]
    energy, phi = _fft_energy_phi(frames)        # (G, 513)

    # --- short FFT windows at offsets 256,384,512 within the savebuf
    sidx = (576 * np.arange(G)[:, None, None] + 128 * (2 + np.arange(3))[None, :, None]
            + np.arange(256)[None, None, :])
    sframes = pad[sidx].astype(np.float32) * win_s[None, None, :]
    energy_s, phi_s = _fft_energy_phi(sframes)   # (G, 3, 129)

    # --- unpredictability cw
    cw = np.full((G, HBLKSIZE), 0.4)
    r = np.sqrt(energy).astype(np.float32).astype(np.float64)
    r1 = np.concatenate([np.zeros((1, HBLKSIZE)), r[:-1]])
    r2 = np.concatenate([np.zeros((2, HBLKSIZE)), r[:-2]])
    phi1 = np.concatenate([np.zeros((1, HBLKSIZE)), phi[:-1]])
    phi2 = np.concatenate([np.zeros((2, HBLKSIZE)), phi[:-2]])
    rp = 2.0 * r1 - r2
    pp = 2.0 * phi1 - phi2
    t1 = r * np.cos(phi) - rp * np.cos(pp)
    t2 = r * np.sin(phi) - rp * np.sin(pp)
    t3 = r + np.abs(rp)
    cw_l = np.where(t3 != 0.0, np.sqrt(t1 * t1 + t2 * t2) / np.where(t3 == 0, 1, t3), 0.0)
    cw[:, :6] = cw_l[:, :6]

    # short-block sqrt stays in double (l3psy.c:536-539 computes
    # sqrt((double)energy_s) inline, unlike the long path where r is a
    # FLOAT array)
    rs = np.sqrt(energy_s)  # (G,3,129)
    k = (np.arange(6, 206, 4) + 2) >> 2        # 2..51
    rp_s = 2.0 * rs[:, 0, k] - rs[:, 2, k]
    pp_s = 2.0 * phi_s[:, 0, k] - phi_s[:, 2, k]
    r2s = rs[:, 1, k]
    p2s = phi_s[:, 1, k]
    t1 = r2s * np.cos(p2s) - rp_s * np.cos(pp_s)
    t2 = r2s * np.sin(p2s) - rp_s * np.sin(pp_s)
    t3 = r2s + np.abs(rp_s)
    cws = np.where(t3 != 0.0, np.sqrt(t1 * t1 + t2 * t2) / np.where(t3 == 0, 1, t3), 0.0)
    cw[:, 6:206] = np.repeat(cws, 4, axis=1)

    # --- partition energies.  eb is double; cb is a float32 buffer in
    # the reference (FLOAT* malloc, l3psy.c:116,140), so each += rounds
    # to f32 after a double add (ascending j, l3psy.c:570-578).
    part_l = P["partition_l"]
    eb = np.zeros((G, CBANDS))
    np.add.at(eb.T, part_l, energy.T)
    cb32 = np.zeros((G, CBANDS), np.float32)
    prod = cw * energy
    for j in range(HBLKSIZE):
        tp = part_l[j]
        cb32[:, tp] = (cb32[:, tp].astype(np.float64) + prod[:, j]).astype(np.float32)

    # --- spreading convolution.  ecb is float32 (rounds every step);
    # ctb is double (sprdngf1/2 signatures, l3psy.c:1062-1084).
    s3 = P["s3_l"]
    if float(sfreq_hz) == 44100.0:
        s3 = s3 * P["s3_mask"]  # sparse bounds, l3psy.c:591-593
    ecb32 = np.zeros((G, CBANDS), np.float32)
    ctb = np.zeros((G, CBANDS))
    cb64 = cb32.astype(np.float64)
    for kk in range(CBANDS):  # ascending-k accumulation like the C loop
        ecb32 = (ecb32.astype(np.float64) + s3[None, :, kk] * eb[:, kk:kk + 1]
                 ).astype(np.float32)
        ctb += s3[None, :, kk] * cb64[:, kk:kk + 1]
    ecb = ecb32.astype(np.float64)

    # --- tonality -> SNR -> thresholds
    with np.errstate(divide="ignore", invalid="ignore"):
        cbb = np.where(ecb != 0.0, np.log(np.maximum(ctb / np.where(ecb == 0, 1, ecb), 0.01)), 0.0)
    tbb = np.clip(-0.299 - 0.43 * cbb, 0.0, 1.0)
    snr_l = np.maximum(P["minval"][None, :], 29.0 * tbb + 6.0 * (1.0 - tbb))
    # nb is a float32 buffer as well (l3psy.c:116,139)
    nb = (ecb * P["norm_l"][None, :] * np.exp(-snr_l * LN)).astype(np.float32).astype(np.float64)
    nb1 = np.concatenate([np.zeros((1, CBANDS)), nb[:-1]])
    nb2 = np.concatenate([np.zeros((2, CBANDS)), nb[:-2]])
    thr = np.maximum(P["qthr_l"][None, :], np.minimum(nb, np.minimum(2.0 * nb1, 16.0 * nb2)))

    # --- perceptual entropy, sequential -= accumulation (l3psy.c:639-645)
    peterms = P["numlines_pe"][None, :] * np.minimum(0.0, np.log((thr + 1.0) / (eb + 1.0)))
    pe = np.zeros(G)
    for b in range(CBANDS):
        pe = pe - peterms[:, b]

    # --- long-block sfb ratios
    en_l = np.zeros((G, SBMAX_L))
    thm_l = np.zeros((G, SBMAX_L))
    for sb in range(SBMAX_L):
        bu, bo = P["bu_l"][sb], P["bo_l"][sb]
        en = P["w1_l"][sb] * eb[:, bu] + P["w2_l"][sb] * eb[:, bo]
        th = P["w1_l"][sb] * thr[:, bu] + P["w2_l"][sb] * thr[:, bo]
        for b in range(bu + 1, bo):
            en = en + eb[:, b]
            th = th + thr[:, b]
        en_l[:, sb] = en
        thm_l[:, sb] = th
    ratio_l = np.where(en_l != 0.0, thm_l / np.where(en_l == 0, 1, en_l), 0.0)

    # --- short-block sfb ratios (for attack granules; computed for all)
    part_s = P["partition_s"]
    eb_s = np.zeros((G, 3, CBANDS))
    np.add.at(eb_s.transpose(2, 0, 1), part_s, energy_s.transpose(2, 0, 1))
    # full conv with the *long* matrix restricted to CBANDS_S
    # (l3psy.c:707-709); ecb/nb are float32 buffers here too
    ecb_s32 = np.zeros((G, 3, CBANDS), np.float32)
    for kk in range(CBANDS_S):
        upd = (ecb_s32[..., :CBANDS_S].astype(np.float64)
               + P["s3_l"][None, None, :CBANDS_S, kk] * eb_s[:, :, kk:kk + 1])
        ecb_s32[..., :CBANDS_S] = upd.astype(np.float32)
    ecb_s = ecb_s32.astype(np.float64)
    nb_s = (ecb_s * P["norm_l"][None, None, :] *
            np.exp(P["snr_s"][None, None, :] * LN)).astype(np.float32).astype(np.float64)
    thr_s = np.maximum(P["qthr_s"][None, None, :], nb_s)
    en_s = np.zeros((G, SBMAX_S, 3))
    thm_s = np.zeros((G, SBMAX_S, 3))
    for sb in range(SBMAX_S):
        bu, bo = P["bu_s"][sb], P["bo_s"][sb]
        en = P["w1_s"][sb] * eb_s[:, :, bu] + P["w2_s"][sb] * eb_s[:, :, bo]
        th = P["w1_s"][sb] * thr_s[:, :, bu] + P["w2_s"][sb] * thr_s[:, :, bo]
        for b in range(bu + 1, bo):
            en = en + eb_s[:, :, b]
            th = th + thr_s[:, :, b]
        en_s[:, sb] = en
        thm_s[:, sb] = th
    ratio_s = np.where(en_s != 0.0, thm_s / np.where(en_s == 0, 1, en_s), 0.0)

    # --- block type FSM with one-granule emission delay
    attack = pe >= SWITCH_PE
    state = mpeg.NORM_TYPE
    emit_bt = np.zeros(G, np.int32)
    for g in range(G):
        if attack[g]:
            emit_bt[g] = mpeg.START_TYPE if state == mpeg.NORM_TYPE else mpeg.SHORT_TYPE
            state = mpeg.SHORT_TYPE
        else:
            emit_bt[g] = state
            state = mpeg.STOP_TYPE if state == mpeg.SHORT_TYPE else mpeg.NORM_TYPE

    # --- delayed ratio emission with per-type staleness: the static
    # ratio/ratio_s arrays only update on the branch taken
    # (l3psy.c:671-684 long, :698-729 short), so the value emitted at g
    # is the one computed at the last granule < g of the matching type.
    out_ratio_l = np.zeros((G, SBMAX_L))
    out_ratio_s = np.zeros((G, SBMAX_S, 3))
    last_l = np.zeros(SBMAX_L)
    last_s = np.zeros((SBMAX_S, 3))
    for g in range(G):
        out_ratio_l[g] = last_l
        out_ratio_s[g] = last_s
        if attack[g]:
            last_s = ratio_s[g]
        else:
            last_l = ratio_l[g]

    return dict(block_type=emit_bt, ratio_l=out_ratio_l, ratio_s=out_ratio_s,
                pe=pe, attack=attack)
