"""Layer I/II analysis in PyTorch (port of mp3tpu/ops/jaxlayer12.py).

Batched over the frames of a clip: the polyphase filterbank (the
matmul form of ``ops/dsp.py``), psy model 2 (Hann window + real FFT over
every analysis window at once, unpredictability from the two previous
windows, partition sums and spreading as matmuls, the 32-subband SNR
translation), scale factors, the Layer II scfsi classes and the
a*x+b quantizers.  The JAX package computes all of this as plain XLA,
so plain torch ops are its port.  ``marshal_frames`` is the torch form of
the JAX package's host marshalling (``encoder._marshal_layer12``), so
that the whole Layer I/II chain stays on the device: the bit allocation
between the analysis and the quantizers is K5 (``ops/alloc12.py``), the
packing after the marshalling K6 (``ops/pack12.py``).

Precision follows the JAX package as its tests run it: filterbank and
psy in float32 (TF32 is off package-wide), scale factors and
quantization in float64 against the float64 ``MULTIPLE`` table.
"""
from functools import lru_cache

import numpy as np
import torch

from ..numpy_ref import psy12 as psy12_ref
from ..runtime.profiling import span
from ..tables import layer12 as L
from ..tables import mpeg

from . import dsp

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def subband_frames(blocks, ngroups, DT):
    """Polyphase analysis over whole frames.  blocks (F, spf) scaled
    samples (x/32768), the clip's start preceded by silence.  Returns
    (F, ngroups, 12, 32) subband samples."""
    nf = blocks.shape[0]
    flat = torch.cat([torch.zeros(512, dtype=torch.float32,
                                  device=blocks.device),
                      blocks.reshape(-1).to(torch.float32)])
    return dsp.polyphase(flat, DT).reshape(nf, ngroups, 12, 32)


@lru_cache(maxsize=None)
def psy_constants(sfreq_hz):
    """Partition and spreading constants from the oracle's init; equal
    to ``jaxlayer12._psy_constants``."""
    P = psy12_ref._init_params(float(sfreq_hz))
    part = P["partition"]
    onehot = np.zeros((psy12_ref.CBANDS, psy12_ref.HBLKSIZE), np.float32)
    onehot[part, np.arange(psy12_ref.HBLKSIZE)] = 1.0
    kk = (P["cbval"].astype(np.float64) + 0.5).astype(np.int64)
    return dict(
        onehot=onehot, s=P["s"].astype(np.float32),
        tmn=P["tmn"].astype(np.float32),
        bmax=psy12_ref._BMAX[kk].astype(np.float32),
        denom=(P["rnorm"].astype(np.float64) * P["numlines"]
               ).astype(np.float32),
        absthr=P["absthr"].astype(np.float32),
        part=part.astype(np.int32))


def hann1024():
    """The model-2 analysis window, built in float64, used in float32."""
    i = np.arange(1024, dtype=np.float64)
    return (0.5 * (1 - np.cos(2.0 * mpeg.REF_PI * (i - 0.5) / 1024))
            ).astype(np.float32)


@lru_cache(maxsize=None)
def device_constants(sfreq_hz, device):
    """psy_constants as tensors on `device` (transposed for the
    matmuls), the Hann window, and the filterbank tables."""
    c = psy_constants(sfreq_hz)
    f = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa
    return dict(onehot_t=f(c["onehot"].T.copy()), s_t=f(c["s"].T.copy()),
                tmn=f(c["tmn"]), bmax=f(c["bmax"]), denom=f(c["denom"]),
                absthr=f(c["absthr"]),
                part=f(c["part"].astype(np.int64)), hann=f(hann1024()),
                dsp=dsp.device_tables(dsp.numpy_constants(), device))


def _shift(x, k):
    """x delayed by k rows along the window axis, zeros in front."""
    return torch.cat([torch.zeros_like(x[:k]), x[:-k]])


def psy_snr32(windows, layer, C):
    """Model-2 SNR for a batch of 1024-sample analysis windows in time
    order.  windows (NW, 1024) float32 (int16-valued samples); C from
    ``device_constants``.  Returns (NW, 32) SNR in dB; for layer 2 the
    caller maxes window pairs."""
    dev = windows.device
    spec = torch.fft.rfft(windows * C["hann"][None, :])
    re, im = spec.real, spec.imag
    energy = re * re + im * im
    # interior-line floor like enphinew (subs.c:67-80)
    line = torch.arange(513, device=dev)
    floored = ((line > 0) & (line < 512))[None, :] & (energy < 0.0005)
    energy = torch.where(floored, 0.0005, energy)
    phi = torch.where(floored, 0.0, torch.atan2(-im, re))

    r = torch.sqrt(energy)
    rp = 2.0 * _shift(r, 1) - _shift(r, 2)
    pp = 2.0 * _shift(phi, 1) - _shift(phi, 2)
    t1 = r * torch.cos(phi) - rp * torch.cos(pp)
    t2 = r * torch.sin(phi) - rp * torch.sin(pp)
    t3 = r + rp.abs()
    c = torch.where(t3 != 0.0, torch.sqrt(t1 * t1 + t2 * t2)
                    / torch.where(t3 == 0, 1.0, t3), 0.0)

    ecb = (energy @ C["onehot_t"]) @ C["s_t"]            # (NW, 63)
    cb = ((energy * c) @ C["onehot_t"]) @ C["s_t"]
    cbn = torch.where(ecb != 0.0, cb / torch.where(ecb == 0, 1.0, ecb),
                      0.0).clamp(0.05, 0.5)
    tb = -0.434294482 * torch.log(cbn) - 0.301029996
    bc = torch.maximum(C["tmn"][None, :] * tb + 5.5 * (1.0 - tb),
                       C["bmax"][None, :])
    bc = torch.exp(-bc * mpeg.LN_TO_LOG10)
    denom = C["denom"]
    nb = torch.where(denom[None, :] != 0.0,
                     ecb * bc / torch.where(denom == 0, 1.0, denom)[None, :],
                     0.0)

    temp1 = torch.maximum(nb[:, C["part"]], C["absthr"][None, :])
    if layer == 1:
        lthr_prev = torch.cat(
            [torch.full((1, 513), 60802371420160.0, dtype=temp1.dtype,
                        device=dev), 32.0 * temp1[:-1]])
        fthr = torch.maximum(temp1 * 0.00316,
                             torch.minimum(temp1, lthr_prev))
    else:
        fthr = temp1

    # 32-subband translation (psy.c:369-387): bands 0..12 use the min
    # threshold, 13..31 the summed thresholds; 17-line windows, stride 16
    seg_t = fthr.unfold(1, 17, 16)                       # (NW, 32, 17)
    seg_e = energy.unfold(1, 17, 16)
    lowband = (torch.arange(32, device=dev) < 13)[None, :]
    thr = torch.where(lowband, seg_t.amin(dim=2) * 17.0, seg_t.sum(dim=2))
    return 4.342944819 * torch.log(seg_e.sum(dim=2) / thr)


def psy_windows(stream, nframes, layer):
    """Analysis windows of the model-2 head (psy.c:258-267 savebuf slide
    as indexing): layer 1 stream[384f-640 : +1024), layer 2 two windows
    per frame at 1152f+576i-480; samples before the clip are zero."""
    dev = stream.device
    pad = 1024
    xp = torch.cat([torch.zeros(pad, dtype=torch.float32, device=dev),
                    stream.to(torch.float32)])
    f = torch.arange(nframes, device=dev)
    if layer == 1:
        starts = 384 * f - 640
    else:
        # the window starts -480 and 96, made on the device: a list
        # uploaded from pageable memory would wait for the stream
        starts = (1152 * f[:, None] - 480
                  + 576 * torch.arange(2, device=dev)[None, :]).reshape(-1)
    idx = pad + starts[:, None] + torch.arange(1024, device=dev)[None, :]
    return xp[idx.clamp(0, xp.shape[0] - 1)]


@span("analyze_frames")
def analyze_frames(pcm, fb_stream, layer, sblimit, nch, nframes, sfreq_hz):
    """Analysis of a whole clip: filterbank + psy + scale factors + scfsi
    (+ the joint-stereo combination).

    pcm (nch, N) int16-valued float32 (the psy input); fb_stream (nch, N)
    the filterbank input (layer 1: the 64-sample delayed copy; layer 2:
    pcm), both on the device.  Returns a dict of tensors on that device:
    sb (nch, F, G, 12, 32), snr (nch, F, 32), scalar (nch, F, G, 32),
    for layer 2 scfsi (nch, F, 32), for stereo j_sample and j_scale."""
    C = device_constants(float(sfreq_hz), pcm.device)
    ngroups = 1 if layer == 1 else 3
    spf = 384 if layer == 1 else 1152
    sbs, snrs = [], []
    for ch in range(nch):
        sbs.append(subband_frames(fb_stream[ch].reshape(nframes, spf)
                                  / 32768.0, ngroups, C["dsp"]))
        snr = psy_snr32(psy_windows(pcm[ch], nframes, layer), layer, C)
        if layer == 2:
            snr = torch.maximum(snr[0::2], snr[1::2])
        snrs.append(snr)
    sb = torch.stack(sbs)                                # (nch, F, G, 12, 32)
    out = dict(sb=sb, snr=torch.stack(snrs))
    scalar = scale_factors(sb.reshape(-1, ngroups, 12, 32), sblimit) \
        .reshape(nch, nframes, ngroups, 32)
    if layer == 2:
        scfsi, scalar = scfsi_pattern(scalar.reshape(-1, 3, 32))
        out["scfsi"] = scfsi.reshape(nch, nframes, 32)
        scalar = scalar.reshape(nch, nframes, 3, 32)
    out["scalar"] = scalar
    if nch == 2:
        out["j_sample"] = 0.5 * (sb[0] + sb[1])
        out["j_scale"] = scale_factors(out["j_sample"], sblimit)
    return out


@lru_cache(maxsize=None)
def _table(name, device):
    """A float64/int64 table of the port's ``tables`` on `device`."""
    return torch.as_tensor(
        {"multiple": mpeg.MULTIPLE, "quant_a": L.QUANT_A,
         "quant_b": L.QUANT_B, "quant_a_l1": L.QUANT_A_L1,
         "quant_b_l1": L.QUANT_B_L1,
         "scfsi_pattern": L.SCFSI_PATTERN}[name], device=device)


@lru_cache(maxsize=None)
def _alloc_table(table, key, device):
    """``ALLOC[table][key]`` (int64, (32, 16) or (32,)) on `device`, made
    once: an upload from pageable memory waits for the stream."""
    return torch.as_tensor(np.asarray(L.ALLOC[table][key]), device=device)


def scale_factors(sb, sblimit):
    """encode.c:536-557: (F, G, 12, 32) -> (F, G, 32) indices into the
    descending MULTIPLE table (63 above sblimit)."""
    s = sb.abs().amax(dim=-2).to(torch.float64)
    neg = -_table("multiple", sb.device)[:63]
    idx = (torch.searchsorted(neg, (-s).contiguous(), right=True) - 1) \
        .clamp(0, 62)
    over = torch.arange(32, device=sb.device)[None, None, :] >= sblimit
    return torch.where(over, 63, idx)


def _select(conds, vals, default):
    """jnp.select: the value of the first true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def scfsi_pattern(scalar):
    """encode.c:626-679 branchless: scalar (F, 3, 32) int ->
    (scfsi (F, 32), new_scalar (F, 3, 32))."""
    d0 = scalar[:, 0] - scalar[:, 1]
    d1 = scalar[:, 1] - scalar[:, 2]

    def cls(d):
        return torch.where(d <= -3, 0, torch.where(
            d < 0, 1, torch.where(d == 0, 2, torch.where(d < 3, 3, 4))))

    pat = _table("scfsi_pattern", scalar.device)[cls(d0), cls(d1)]
    s0, s1, s2 = scalar[:, 0], scalar[:, 1], scalar[:, 2]
    m02 = torch.minimum(s0, s2)
    scfsi = _select([pat == 0x123, (pat == 0x122) | (pat == 0x133),
                     pat == 0x113], [0, 3, 1], torch.full_like(pat, 2))
    n0 = _select([pat == 0x222, pat == 0x333, pat == 0x444],
                 [s1, s2, m02], s0)
    n1 = _select([pat == 0x122, pat == 0x133, pat == 0x113, pat == 0x111,
                  pat == 0x222, pat == 0x333, pat == 0x444],
                 [s1, s2, s0, s0, s1, s2, m02], s1)
    n2 = _select([pat == 0x122, pat == 0x111, pat == 0x222, pat == 0x333,
                  pat == 0x444], [s1, s0, s1, s2, m02], s2)
    return scfsi, torch.stack([n0, n1, n2], dim=1)


def _apply_quant(d, a, b, nbits):
    """dq = a*d + b, MSB inversion, truncate to nbits (encode.c:1250-1258
    / 1295-1316).  The float -> int conversion saturates as XLA's does."""
    dq = d * a + b
    sig = dq >= 0
    dq = torch.where(sig, dq, dq + 1.0)
    v = torch.floor(dq * torch.exp2(nbits.to(d.dtype))) \
        .clamp(_INT32_MIN, _INT32_MAX).to(torch.int64)
    return v | torch.where(sig, torch.ones_like(nbits) << nbits, 0)


@span("quantize_l1")
def quantize_l1(sb, scalar, bit_alloc):
    """Layer I quantization (encode.c:1205-1259).  sb (F, 1, 12, 32);
    scalar (F, 1, 32); bit_alloc (F, 32).  Returns int64 codes
    (F, 1, 12, 32), junk where bit_alloc == 0."""
    dev = sb.device
    d = sb.to(torch.float64) \
        / _table("multiple", dev)[scalar.to(torch.int64)][:, :, None, :]
    ba = bit_alloc.to(torch.int64).clamp(min=1)[:, None, None, :]
    return _apply_quant(d, _table("quant_a_l1", dev)[ba - 1],
                        _table("quant_b_l1", dev)[ba - 1], ba)


@span("quantize_l2")
def quantize_l2(sb, scalar, bit_alloc, table):
    """Layer II quantization (encode.c:1264-1321).  sb (F, 3, 12, 32);
    scalar (F, 3, 32); bit_alloc (F, 32).  Returns int64 codes
    (F, 3, 12, 32), junk where bit_alloc == 0."""
    dev = sb.device
    d = sb.to(torch.float64) \
        / _table("multiple", dev)[scalar.to(torch.int64)][:, :, None, :]
    cols = torch.arange(32, device=dev)[None, :]
    ba = bit_alloc.to(torch.int64)
    qnt = _alloc_table(table, "quant", dev)[cols, ba]             # (F, 32)
    steps = _alloc_table(table, "steps", dev)[cols, ba]
    a = _table("quant_a", dev)[qnt][:, None, None, :]
    b = _table("quant_b", dev)[qnt][:, None, None, :]
    # n: the smallest n with 2^n >= steps, minus 1 (encode.c:1299-1311);
    # L2 steps are 2^k - 1 or 3/5/9, so ceil(log2(steps)) - 1, in float64
    nbits = (torch.ceil(torch.log2(steps.clamp(min=2).to(torch.float64)))
             .to(torch.int64) - 1)[:, None, None, :]
    return _apply_quant(d, a, b, nbits)


def anc_slots(adb, layer, table, sblimit, nch, error_protection):
    """The ancillary zero fill's 32-bit slots a frame of ``marshal_frames``
    holds: the frame's bits less its fixed fields (header, CRC and the
    smallest bit-allocation field, every subband at or above jsbound
    sending one channel's), rounded up -- a bound on any frame's
    ``adb_left``, so that the element layout is static."""
    if layer == 1:
        bbal = 4 * 32
    else:
        bbal = int(np.asarray(L.ALLOC[table]["nbal"])[:sblimit].sum())
    rest = adb - 32 - (16 if error_protection else 0) - bbal
    return max(0, -(-rest // 32))


def _u32(v):
    """int64 values' low 32 bits as int32 bit patterns."""
    v = v & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


@span("_marshal_layer12")
def marshal_frames(cfg, layer, table, sblimit, nch, mode, mode_ext, jsbound,
                   ba, scfsi, scalar, codes, adb_left, adb):
    """The (value, length) elements of every frame, frame-major: the torch
    counterpart of ``encoder._marshal_layer12`` (musicin.c:621-705),
    vectorized over frames as it is.  Per frame: header, [CRC (16 zero
    bits, for K6 to fill)], bit allocation (sb outer, ch inner), [scfsi,]
    scale factors, samples, then ``anc_slots`` ancillary slots of zeros
    (the last ones of length 0), so that E is fixed per (layer, nch,
    table) and nothing is read back from the device.

    mode, mode_ext, jsbound, adb_left (F,) and ba (F, 2, 32) integer
    tensors; scfsi (nch, F, 32) or None; scalar (nch, F, G, 32); codes
    (nch, F, G, 12, 32) int64; adb the frame's bits.  Returns (values,
    lengths) (F, E) int32 (values as 32-bit patterns) on their device and
    the CRC's element range (first, end) -- the bit allocation and the
    scfsi -- or None without error protection."""
    dev = ba.device
    F = ba.shape[0]
    i64 = torch.int64
    sbs = torch.arange(32, device=dev)
    js = sbs[None, :] >= jsbound.to(i64)[:, None]             # (F, 32)
    active = (sbs < sblimit).to(i64)[None, :]                 # (1, 32)
    ba = ba[:, :nch].to(i64)                                  # (F, nch, 32)
    has = ba != 0

    def full(val, k):
        return torch.full((F, k), val, dtype=i64, device=dev)

    # --- header word (encode.c:419-438)
    hdr = (0xFFF << 20) | (cfg.version << 19) | ((4 - layer) << 17) \
        | ((0 if cfg.error_protection else 1) << 16) \
        | (cfg.bitrate_index << 12) | (cfg.sampling_frequency << 10) \
        | (cfg.extension << 8) \
        | (int(cfg.copyright) << 3) | (int(cfg.original) << 2) \
        | cfg.emphasis
    header = hdr | (mode.to(i64) << 6) | (mode_ext.to(i64) << 4)
    blocks = [(header[:, None], full(32, 1))]
    if cfg.error_protection:
        blocks.append((full(0, 1), full(16, 1)))
    crc_first = sum(v.shape[1] for v, _ in blocks)

    # --- bit allocation: sb outer, ch inner
    nbal = (torch.full((32,), 4, dtype=i64, device=dev) if layer == 1
            else _alloc_table(table, "nbal", dev))
    bal = (nbal[None, :] * active).expand(F, 32)
    bal = torch.stack([bal] + ([torch.where(js, 0, bal)] if nch == 2
                               else []), dim=2)           # (F, 32, nch)
    blocks.append((ba.transpose(1, 2).reshape(F, -1), bal.reshape(F, -1)))

    if layer == 2:
        scf = scfsi.to(i64).permute(1, 2, 0)                   # (F, 32, nch)
        hasT = has.transpose(1, 2)                             # (F, 32, nch)
        blocks.append((scf.reshape(F, -1),
                       torch.where(hasT, 2, 0).reshape(F, -1)))
        crc_end = sum(v.shape[1] for v, _ in blocks)
        # --- scale factors: 3 slots per (sb, ch)
        s = scalar.to(i64).permute(1, 3, 0, 2)          # (F, 32, nch, 3)
        fv = torch.stack([s[..., 0], torch.where(scf == 0, s[..., 1],
                                                 s[..., 2]), s[..., 2]],
                         dim=3)
        fl = torch.stack([torch.where(hasT, 6, 0),
                          torch.where(hasT & (scf != 2), 6, 0),
                          torch.where(hasT & (scf == 0), 6, 0)], dim=3)
        blocks.append((fv.reshape(F, -1), fl.reshape(F, -1)))
        # --- samples: t(3) x triple(4) x sb x ch, 3 slots each
        cols = sbs[None, None, :]
        grp = _alloc_table(table, "group", dev)[cols, ba]      # (F, nch, 32)
        nbits = _alloc_table(table, "bits", dev)[cols, ba]
        y = _alloc_table(table, "steps", dev)[cols, ba]
        c3 = codes.to(i64).permute(1, 2, 3, 4, 0) \
            .reshape(F, 3, 4, 3, 32, nch)
        s0, s1, s2 = c3[:, :, :, 0], c3[:, :, :, 1], c3[:, :, :, 2]

        def lanes(x):           # (F, nch, 32) -> (F, 1, 1, 32, nch)
            return x.transpose(1, 2)[:, None, None]

        grouped = lanes((grp == 1) & has)
        ungrouped = lanes((grp == 3) & has)
        yl = lanes(y)
        gval = s0 + s1 * yl + s2 * (yl * yl)
        bl = lanes(nbits)
        zero = torch.zeros_like(bl)
        l0 = torch.where(lanes(has), bl, zero)
        l12 = torch.where(ungrouped, bl, zero)
        if nch == 2:
            # above jsbound only channel 0's lane is sent
            top = torch.stack([torch.zeros_like(js), js], dim=1)
            top = lanes(top)
            l0 = torch.where(top, 0, l0)
            l12 = torch.where(top, 0, l12)
        sval = torch.stack([torch.where(grouped, gval, s0), s1, s2], dim=5)
        slen = torch.stack([l0, l12, l12], dim=5).expand(sval.shape)
        blocks.append((sval.reshape(F, -1), slen.reshape(F, -1)))
    else:
        crc_end = sum(v.shape[1] for v, _ in blocks)
        hasT = has.transpose(1, 2)                             # (F, 32, nch)
        # --- layer 1 scale factors: 1 slot per (sb, ch)
        blocks.append((scalar[:, :, 0].to(i64).permute(1, 2, 0)
                       .reshape(F, -1),
                       torch.where(hasT, 6, 0).reshape(F, -1)))
        # --- samples: j(12) x sb x ch, ba+1 bits
        c = codes.to(i64)[:, :, 0].permute(1, 2, 3, 0)  # (F, 12, 32, nch)
        sl = torch.where(hasT, ba.transpose(1, 2) + 1, 0)       # (F, 32, nch)
        if nch == 2:
            sl = torch.stack([sl[..., 0], torch.where(js, 0, sl[..., 1])],
                             dim=2)
        blocks.append((c.reshape(F, -1),
                       sl[:, None].expand(F, 12, 32, nch).reshape(F, -1)))

    # --- ancillary zero fill, 32-bit slots
    nslots = anc_slots(adb, layer, table, sblimit, nch, cfg.error_protection)
    if nslots:
        rem = adb_left.to(i64)[:, None] \
            - 32 * torch.arange(nslots, device=dev)[None, :]
        blocks.append((torch.zeros((F, nslots), dtype=i64, device=dev),
                       rem.clamp(0, 32)))

    values = torch.cat([_u32(v) for v, _ in blocks], dim=1)
    lengths = torch.cat([n.to(torch.int32) for _, n in blocks], dim=1)
    return (values, lengths,
            (crc_first, crc_end) if cfg.error_protection else None)
