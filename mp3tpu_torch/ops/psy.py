"""Psychoacoustic model 2 in PyTorch (port of mp3tpu/ops/jaxpsy.py).

The 1024/256-point real DFTs stay float32 matmuls against the JAX
package's cos/sin matrices; partition sums, spreading and sfb
conversion are constant matrices; the unpredictability measure uses
complex products instead of atan2/cos/sin.  The block-type automaton
is a prefix composition of 4-entry transition maps, computed with a
log-step (doubling) scan on the device.

Every function works on a batch of lanes (a leading axis L: the
channels of a segment, or a corpus group's): one call, and one launch
of each op, for all lanes; ``lanes.mm`` runs each product.
"""
from functools import lru_cache

import numpy as np
import torch

from ..tables import mpeg
from ..tables.psy import (CBANDS, CBANDS_S, SBMAX_L, SBMAX_S,
                          psy_params_for_sfreq)
from . import graphs, lanes

LN = mpeg.LN_TO_LOG10
SWITCH_PE = 1800.0


@lru_cache(maxsize=None)
def dft_mats(n):
    k = np.arange(n)[:, None]
    f = np.arange(n // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n
    return np.cos(ang), -np.sin(ang)  # X = x @ (C + iS), rfft convention


@lru_cache(maxsize=None)
def hann(n):
    i = np.arange(n)
    return (0.5 * (1 - np.cos(2.0 * mpeg.REF_PI * (i - 0.5) / n))) \
        .astype(np.float32)


def _sfb_conv(P, suffix, nsb):
    conv = np.zeros((CBANDS, nsb))
    for sb in range(nsb):
        bu, bo = P["bu_" + suffix][sb], P["bo_" + suffix][sb]
        conv[bu, sb] += P["w1_" + suffix][sb]
        conv[bo, sb] += P["w2_" + suffix][sb]
        for b in range(bu + 1, bo):
            conv[b, sb] += 1.0
    return conv


@lru_cache(maxsize=None)
def psy_mats(sfreq_hz):
    """Constant matrices for one sample rate; equal to jaxpsy._psy_mats."""
    P = psy_params_for_sfreq(sfreq_hz)
    # partition one-hot incl. the catch-all partition 0
    part_l = np.zeros((513, CBANDS))
    part_l[np.arange(513), P["partition_l"]] = 1.0
    part_s = np.zeros((129, CBANDS))
    part_s[np.arange(129), P["partition_s"]] = 1.0
    s3 = P["s3_l"]
    if abs(sfreq_hz - 44100.0) < 1:
        s3 = s3 * P["s3_mask"]
    s3_short = P["s3_l"].copy()
    s3_short[CBANDS_S:, :] = 0.0
    s3_short[:, CBANDS_S:] = 0.0
    return dict(P=P, part_l=part_l, part_s=part_s, s3=s3, s3_short=s3_short,
                conv_l=_sfb_conv(P, "l", SBMAX_L),
                conv_s=_sfb_conv(P, "s", SBMAX_S))


def numpy_constants(sfreq_hz):
    """The numpy constants this module's tensors are made from, in the
    JAX package's form: psy_mats (jaxpsy._psy_mats), dft (jaxpsy._dft_mats
    by size), hann (jaxpsy._hann by size)."""
    return dict(psy_mats=psy_mats(float(sfreq_hz)),
                dft={n: dft_mats(n) for n in (1024, 256)},
                hann={n: hann(n) for n in (1024, 256)})


def device_tables(c, device):
    """Tensors on `device` from ``numpy_constants()``-shaped `c`: the
    float32 matrices, and the block-type automaton's two transition maps
    and the short-derived lines' indices (int64).  Equal constants on one
    device give the same tensors (``graphs.shared_tensors``)."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    M, P = c["psy_mats"], c["psy_mats"]["P"]
    out = dict(part_l=f(M["part_l"]), part_s=f(M["part_s"]),
               s3_t=f(np.asarray(M["s3"]).T),
               s3_short_t=f(np.asarray(M["s3_short"]).T),
               conv_l=f(M["conv_l"]), conv_s=f(M["conv_s"]))
    for k in ("minval", "norm_l", "qthr_l", "numlines_pe", "snr_s",
              "qthr_s"):
        out[k] = f(P[k])
    for n in (1024, 256):
        out[f"dft_c{n}"] = f(c["dft"][n][0])
        out[f"dft_s{n}"] = f(c["dft"][n][1])
        out[f"hann{n}"] = f(c["hann"][n])
    out.update(fsm_attack=np.array(_M_ATTACK, np.int64),
               fsm_calm=np.array(_M_CALM, np.int64),
               short_lines=SHORT_LINES)
    return graphs.shared_tensors(out, device)


def _frames_long(blocks, halo2):
    """(L, G, 1024) windows [tail 192 of g-2 | g-1 | head 256 of g]."""
    allb = torch.cat([halo2, blocks], dim=1)
    return torch.cat([allb[:, :-2, 384:], allb[:, 1:-1, :],
                      allb[:, 2:, :256]], dim=2)


def _frames_short(blocks, halo2):
    """(L, G, 3, 256) short windows at offsets 256/384/512 of the
    savebuf."""
    allb = torch.cat([halo2, blocks], dim=1)
    base = torch.cat([allb[:, :-1], allb[:, 1:]], dim=2)   # (L, G+1, 1152)
    return torch.stack([base[:, 1:, 64 + 128 * w: 64 + 128 * w + 256]
                        for w in range(3)], dim=2)


def _spectrum(frames, n, PT):
    re = lanes.mm(frames, PT[f"dft_c{n}"], f"dft_c{n}")
    im = lanes.mm(frames, PT[f"dft_s{n}"], f"dft_s{n}")
    energy = re * re + im * im
    # energy floor with zero-phase convention (subs.c:67-80)
    line = torch.arange(n // 2 + 1, device=frames.device)
    interior = (line > 0) & (line < n // 2)
    floored = (energy < 0.0005) & interior
    energy = torch.where(floored, 0.0005, energy)
    re = torch.where(floored, torch.sqrt(energy), re)
    im = torch.where(floored, 0.0, im)
    return re, im, energy


_M_ATTACK = (2, 2, 2, 2)
_M_CALM = (0, 0, 3, 0)
#: the long line of each short-derived unpredictability value (lines
#: 6..205 in steps of 4 take short line (k + 2) >> 2)
SHORT_LINES = (np.arange(6, 206, 4) + 2) >> 2


def fsm_maps(attack, PT):
    """Per-granule transition maps (..., G, 4) of the block-type
    automaton over states 0=NORM, 2=SHORT, 3=STOP, from the psy tables'
    two maps."""
    return torch.where(attack[..., None], PT["fsm_attack"], PT["fsm_calm"])


def fsm_compose(a, b):
    """Compose maps over states [0..3]: (b.a)[s] = b[a[s]]."""
    return torch.gather(b, -1, a)


def fsm_prefix(maps):
    """Inclusive prefix composition along axis 0: out[g] = maps[g] . ...
    . maps[0], by doubling -- log2(G) composition steps, no per-granule
    loop."""
    out = maps
    d = 1
    G = maps.shape[0]
    while d < G:
        out = torch.cat([out[:d], fsm_compose(out[:-d], out[d:])], dim=0)
        d *= 2
    return out


def _fsm_blocktype(attack, init_state, PT):
    """Emitted block types and final automaton states of attack
    sequences (L, G) from initial states (L,), every lane's prefix along
    its granule axis at once; (G,) and () for one lane."""
    if attack.dim() == 1:
        emit, final = _fsm_blocktype(attack[None], init_state.reshape(1),
                                     PT)
        return emit[0], final[0]
    prefix = fsm_prefix(fsm_maps(attack, PT).transpose(0, 1)) \
        .transpose(0, 1)                                     # (L, G, 4)
    init = init_state.to(torch.int64).reshape(-1, 1)         # (L, 1)
    pre = torch.gather(prefix, 2, init[:, :, None].expand(
        -1, prefix.shape[1], 1))[:, :, 0]                     # (L, G)
    states = torch.cat([init, pre[:, :-1]], dim=1)
    emit = torch.where(attack, torch.where(states == 0, 1, 2), states)
    return emit.to(torch.int32), pre[:, -1].to(torch.int32)


def _unpredictability(re0, im0, r0, re1, im1, r1, re2, im2, r2):
    """cw = |X - r' u| / (r + |r'|), u = unit(2 phi1 - phi2)."""
    rp = 2.0 * r1 - r2
    d1 = torch.where(r1 == 0, 1.0, r1)
    d2 = torch.where(r2 == 0, 1.0, r2)
    u1re = torch.where(r1 == 0, 1.0, (re1 * re1 - im1 * im1) / (d1 * d1))
    u1im = torch.where(r1 == 0, 0.0, (2.0 * re1 * im1) / (d1 * d1))
    c2re = torch.where(r2 == 0, 1.0, re2 / d2)
    c2im = torch.where(r2 == 0, 0.0, -im2 / d2)
    ure = u1re * c2re - u1im * c2im
    uim = u1im * c2re + u1re * c2im
    t1 = re0 - rp * ure
    t2 = im0 - rp * uim
    t3 = r0 + torch.abs(rp)
    return torch.where(t3 != 0.0,
                       torch.sqrt(t1 * t1 + t2 * t2)
                       / torch.where(t3 == 0, 1.0, t3), 0.0)


def _shift(x, n):
    """x (L, G, ...) delayed by n granules (zeros shifted in)."""
    return torch.cat([torch.zeros_like(x[:, :n]), x[:, :-n]], dim=1)


def psycho_granules(blocks, halo2, PT, warmup=0, fsm_init=None):
    """Model-2 analysis for a batch of granules of each lane.

    blocks (L, G, 576) raw PCM values (int16 range, as float); halo2
    (L, 2, 576) the preceding blocks; the first `warmup` granules are
    history only.  fsm_init: (L,) int automaton states carried from the
    previous chunk (None = NORM).  Returns pe (L, G'), ratio_l (L, G',
    21), ratio_s (L, G', 12, 3), attack, block_type (emitted) and
    fsm_state (L,), G' = G - warmup.  One lane may come without its lane
    axis: blocks (G, 576), halo2 (2, 576), fsm_init (); so do its
    results.  It builds no tensor from host data and reads none back, so
    that a CUDA graph can capture it.
    """
    if blocks.dim() == 2:
        out = psycho_granules(blocks[None], halo2[None], PT, warmup,
                              None if fsm_init is None
                              else fsm_init.reshape(1))
        return {k: v[0] for k, v in out.items()}
    blocks = blocks.to(torch.float32)
    halo2 = halo2.to(torch.float32)
    dev = blocks.device
    L, G = blocks.shape[:2]
    frames_l = _frames_long(blocks, halo2) * PT["hann1024"]
    re, im, energy = _spectrum(frames_l, 1024, PT)          # (L, G, 513)
    frames_s = _frames_short(blocks, halo2) * PT["hann256"]
    re_s, im_s, energy_s = _spectrum(frames_s, 256, PT)     # (L, G, 3, 129)

    r = torch.sqrt(energy)
    # unpredictability, long lines 0..5 (two-granule history)
    cw = _unpredictability(re, im, r, _shift(re, 1), _shift(im, 1),
                           _shift(r, 1), _shift(re, 2), _shift(im, 2),
                           _shift(r, 2))
    # short-derived lines 6..205 (within-granule, 3 sub-blocks)
    rs = torch.sqrt(energy_s)
    k = PT["short_lines"]
    cws = _unpredictability(
        re_s[:, :, 1, k], im_s[:, :, 1, k], rs[:, :, 1, k],
        re_s[:, :, 0, k], im_s[:, :, 0, k], rs[:, :, 0, k],
        re_s[:, :, 2, k], im_s[:, :, 2, k], rs[:, :, 2, k])
    cw_full = torch.cat([cw[..., :6], cws.repeat_interleave(4, dim=-1),
                         torch.full((L, G, 513 - 206), 0.4, device=dev)],
                        dim=-1)

    # partition energies and spreading
    eb = lanes.mm(energy, PT["part_l"], "partition_energy")  # (L, G, 63)
    cbw = lanes.mm(cw_full * energy, PT["part_l"], "partition_tonality")
    ecb = lanes.mm(eb, PT["s3_t"], "spread_energy")
    ctb = lanes.mm(cbw, PT["s3_t"], "spread_tonality")

    # tonality -> SNR -> thresholds with pre-echo memory
    cbb = torch.where(
        ecb != 0.0,
        torch.log(torch.clamp(ctb / torch.where(ecb == 0, 1.0, ecb),
                              min=0.01)), 0.0)
    tbb = torch.clamp(-0.299 - 0.43 * cbb, 0.0, 1.0)
    snr_l = torch.maximum(PT["minval"], 29.0 * tbb + 6.0 * (1.0 - tbb))
    nb = ecb * PT["norm_l"] * torch.exp(-snr_l * LN)
    thr = torch.maximum(PT["qthr_l"],
                        torch.minimum(nb, torch.minimum(2.0 * _shift(nb, 1),
                                                        16.0 * _shift(nb, 2))))

    # perceptual entropy (with the reference's clobbered numlines)
    pe = -(PT["numlines_pe"]
           * torch.clamp(torch.log((thr + 1.0) / (eb + 1.0)), max=0.0)
           ).sum(dim=-1)

    # long sfb ratios
    en_l = lanes.mm(eb, PT["conv_l"], "sfb_energy_l")
    thm_l = lanes.mm(thr, PT["conv_l"], "sfb_threshold_l")
    ratio_l = torch.where(en_l != 0.0,
                          thm_l / torch.where(en_l == 0, 1.0, en_l), 0.0)

    # short sfb ratios
    eb_s = lanes.mm(energy_s, PT["part_s"], "partition_energy_s")
    ecb_s = lanes.mm(eb_s, PT["s3_short_t"], "spread_energy_s")
    nb_sv = ecb_s * PT["norm_l"] * torch.exp(PT["snr_s"] * LN)
    thr_s = torch.maximum(PT["qthr_s"], nb_sv)
    en_s = lanes.mm(eb_s, PT["conv_s"], "sfb_energy_s")     # (L, G, 3, 12)
    thm_s = lanes.mm(thr_s, PT["conv_s"], "sfb_threshold_s")
    ratio_s = torch.where(en_s != 0.0,
                          thm_s / torch.where(en_s == 0, 1.0, en_s), 0.0)
    ratio_s = ratio_s.transpose(-1, -2)                     # (L, G, 12, 3)

    attack = pe >= SWITCH_PE
    if warmup:
        pe, ratio_l, ratio_s, attack = (x[:, warmup:] for x in
                                        (pe, ratio_l, ratio_s, attack))
    if fsm_init is None:
        fsm_init = torch.zeros(L, dtype=torch.int32, device=dev)
    block_type, fsm_state = _fsm_blocktype(attack, fsm_init, PT)
    return dict(pe=pe, ratio_l=ratio_l, ratio_s=ratio_s, attack=attack,
                block_type=block_type, fsm_state=fsm_state)
