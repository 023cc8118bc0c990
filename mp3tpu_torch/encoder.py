"""Layer III one-shot encoder on PyTorch (port of the fast path of
mp3tpu/encoder.py).

Per clip: the PCM is cut into super-chunk segments
(``_plan_segments``); each segment runs one ``Layer3SegmentEncoder``
call -- analysis + demand encode -> reservoir scan -> final encode +
packing -- with the block-type automaton state and the reservoir level
carried from segment to segment; the side table and the compacted
payload come to the host; then the reservoir guard validates the
realized part2_3_length chain (clamp + re-encode on the rare overdraw)
and the native assembler (native/mp3bits.cpp) writes the stream.
"""
import numpy as np
import torch

from mp3tpu.config import EncoderConfig
from mp3tpu.runtime.bitstream import (NativeAssembler, guard_clamp,
                                      resv_guard)
from mp3tpu.tables import mpeg

from . import resolve_device
from .models.layer3 import Layer3SegmentEncoder
from .ops import bits

#: super-chunk buckets (granules per channel per segment), as in the
#: JAX package, so that segments line up with it
SUPER_BUCKETS = (256, 1024, 2048)


def _plan_segments(G, buckets=SUPER_BUCKETS):
    """Greedy super-chunk plan [(start, n_real, n_padded)]: a small first
    segment (the smallest bucket) when the clip spans more than one big
    bucket, full largest-bucket segments, and one remainder padded to
    the smallest covering bucket.  Only the last segment is padded, so
    the carried state always comes from real granules."""
    plan = []
    pos = 0
    big = buckets[-1]
    ramp = buckets[0]
    if ramp < big and G > big + ramp:
        plan.append((0, ramp, ramp))
        pos = ramp
    while G - pos > big:
        plan.append((pos, big, big))
        pos += big
    rem = G - pos
    for b in buckets:
        if rem <= b:
            return plan + [(pos, rem, b)]
    return plan + [(pos, rem, big)]


def _stitch_flat(plan, seg_sides, seg_flats, nch, lane0=0, G=None):
    """Stitch per-segment compacted payloads into one clip-order flat
    buffer + per-granule word offsets for the native assembler.

    seg_sides: per segment (n_lanes*n_pad, 19) side tables (p23 at col
    0); seg_flats: per segment flat uint32 payloads in lane order.
    lane0: the clip's first channel lane within the segment lane axis.
    G: the clip's real granule count when SHORTER than the plan's
    coverage.  Tail granules past G are excluded from spans AND offsets
    together: they are not reliably silent (the MDCT overlap of the last
    real granule rings into the first padded one).
    Returns (clip_flat uint32, offsets (nch*G,) int64)."""
    spans = [[] for _ in range(nch)]
    for (pos, n_real, n_pad), side_s, flat in zip(plan, seg_sides,
                                                  seg_flats):
        clip_n = n_real if G is None else max(0, min(n_real, G - pos))
        if clip_n == 0:
            continue
        p23 = np.asarray(side_s)[:, 0].astype(np.int64)
        wlen = (p23 + 31) >> 5
        end = np.cumsum(wlen)
        off = end - wlen
        flat = np.asarray(flat)
        for ch in range(nch):
            lo = (lane0 + ch) * n_pad
            spans[ch].append((flat[off[lo]:end[lo + clip_n - 1]],
                              wlen[lo:lo + clip_n]))
    pieces = [p for ch in range(nch) for p, _ in spans[ch]]
    wlens = [w for ch in range(nch) for _, w in spans[ch]]
    clip_flat = (np.concatenate(pieces) if pieces
                 else np.zeros(0, np.uint32))
    wlen_clip = np.concatenate(wlens)
    offs = np.cumsum(wlen_clip) - wlen_clip
    return clip_flat, offs.astype(np.int64)


def _marshal_and_assemble(cfg, side, payload, nframes, bits_per_frame,
                          mean_bits, resv_max, sfb_s, scfsi=None):
    """Native whole-clip assembly (reservoir.c:141-226 frame loop +
    side-info emission + payload splice) of the (nch, G, 19) side table
    and the compacted payload (flat, row_offsets)."""
    nch = cfg.nchannels
    G = nframes * cfg.mode_gr
    flat, row_offsets = payload
    side = np.ascontiguousarray(np.asarray(side, np.int32))
    if side.shape != (nch, G, 19):
        raise ValueError(f"side table shape {side.shape} != {(nch, G, 19)}")
    asm = NativeAssembler(cfg, np.asarray(sfb_s, np.int32))
    if scfsi is None:
        scfsi = np.zeros((nch, nframes, 4), np.int32)
    # native layout: (nframes, nch, 4)
    scfsi_fm = np.ascontiguousarray(
        np.asarray(scfsi, np.int32).transpose(1, 0, 2))
    asm.encode_clip_payload(nframes, bits_per_frame, mean_bits, resv_max,
                            scfsi_fm, side, np.ascontiguousarray(flat),
                            row_offsets=row_offsets)
    return asm.finish()


def encode_layer3_fast(pcm, cfg: EncoderConfig, device, chunk=None,
                       delta=28, pw=96):
    """Encode int16 PCM (samples x channels, or channels x samples) to
    MPEG-1 Layer III bytes on `device` ("cuda" or "cpu"; CUDA must be
    present when asked for).

    chunk: one super-chunk bucket for every segment (default: the
    SUPER_BUCKETS plan).  delta: predicted slack of reservoir-limited
    granules, folded into the budget scan.  pw: initial payload row
    width in 32-bit words (re-bucketed wider when a granule needs it).
    """
    dev = resolve_device(device)
    cfg.finalize()
    if cfg.layer != 3:
        raise ValueError("encode_layer3_fast encodes Layer III only")
    if cfg.version != mpeg.MPEG1:
        raise NotImplementedError(
            "mp3tpu_torch: MPEG-2 LSF (16/22.05/24 kHz) is not ported yet")
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    if pcm.shape[0] > pcm.shape[1]:
        pcm = pcm.T
    nch = cfg.nchannels
    if pcm.shape[0] != nch:
        raise ValueError(f"pcm has {pcm.shape[0]} channels, config {nch}")
    spf = cfg.samples_per_frame
    mode_gr = cfg.mode_gr
    nframes = int(np.ceil(pcm.shape[1] / spf))
    total = nframes * spf
    pcm = np.pad(pcm, ((0, 0), (0, total - pcm.shape[1])))
    G = nframes * mode_gr
    sfb_s = mpeg.sfb_short(cfg.version, cfg.sampling_frequency)
    # float-input sanitization: NaN -> 0, +/-Inf -> full scale
    pcm = np.clip(np.nan_to_num(pcm, nan=0.0, posinf=32767.0,
                                neginf=-32768.0), -32768, 32767)
    blocks = pcm.astype(np.int16).reshape(nch, G, 576)
    plan = _plan_segments(G, (chunk,) if chunk else SUPER_BUCKETS)

    whole_spf, _ = cfg.slots_per_frame()
    bits_per_frame = 8 * whole_spf
    sideinfo_len = mpeg.sideinfo_bits(cfg.version, nch, cfg.error_protection)
    mean_bits = (bits_per_frame - sideinfo_len) // mode_gr
    resv_max = min(max(0, 7680 - bits_per_frame), 4088)

    enc = Layer3SegmentEncoder(cfg.version, cfg.sampling_frequency, dev)

    def cap_for(n_pad):
        return bits.payload_cap_words(n_pad // mode_gr, bits_per_frame,
                                      sideinfo_len, resv_max, nch * n_pad)

    # ---- one segment program per plan entry, state carried across
    segs, got = [], []
    fsm = torch.zeros(nch, dtype=torch.int32, device=dev)
    size = 0
    for pos, n_real, n_pad in plan:
        bl = np.zeros((nch, 4 + n_pad, 576), np.int16)
        if pos:
            bl[:, :4] = blocks[:, pos - 4: pos]
        bl[:, 4:4 + n_real] = blocks[:, pos: pos + n_real]
        h = enc(torch.as_tensor(bl, device=dev), fsm, size, pw, nch,
                cap_for(n_pad), n_real, mean_bits, resv_max, mode_gr, delta)
        fsm, size = h["fsm_state"], h["size"]
        segs.append(h)
        got.append((h["side"].cpu().numpy(), bits.to_uint32(h["payload"]),
                    h["scfsi"].cpu().numpy()))

    def concat_real(parts):
        """per-segment (nch*n_pad, ...) -> (nch, G, ...) real granules."""
        return np.concatenate(
            [np.asarray(p).reshape((nch, n_pad) + np.shape(p)[1:])[:, :n_real]
             for (_, n_real, n_pad), p in zip(plan, parts)], axis=1)

    side = concat_real([g[0] for g in got])
    payload = _stitch_flat(plan, [g[0] for g in got], [g[1] for g in got],
                           nch)
    scfsi_frames = np.concatenate(
        [g[2][:, :n_real // 2] for (_, n_real, _), g in zip(plan, got)],
        axis=1)                                           # (nch, F, 4)

    def scan_tensors():
        """The scan's (target, demand), real granules only (retry paths)."""
        return tuple(
            np.concatenate([s[k][:, :n_real].cpu().numpy()
                            for (_, n_real, _), s in zip(plan, segs)],
                           axis=1).astype(np.int64)
            for k in ("target", "demand"))

    def run_final(pw, target, demand):
        outs = []
        for (pos, n_real, n_pad), s in zip(plan, segs):
            bh = np.full((nch, n_pad), 4095.0, np.float32)
            t = target[:, pos: pos + n_real]
            d = demand[:, pos: pos + n_real]
            bh[:, :n_real] = np.where(t < d, t, 4095)
            h = enc.encode_final(
                s["xr"], s["ratio_l"], s["ratio_s"], s["block_type"],
                torch.as_tensor(bh.reshape(-1), device=dev),
                payload_words=pw, scfsi=s["scfsi"], sf_fix=s["sf_fix"],
                nch=nch, qss_lo=s["qss"], flat_cap=cap_for(n_pad))
            outs.append((h["side"].cpu().numpy(),
                         bits.to_uint32(h["payload"])))
        return (concat_real([o[0] for o in outs]),
                _stitch_flat(plan, [o[0] for o in outs],
                             [o[1] for o in outs], nch))

    # the dense encode is the authority on p23:
    # (a) a granule can exceed its payload row -> re-bucket wider;
    # (b) the reservoir guard can flag an overdraw -> clamp the budgets
    #     (cumulatively across retries) and re-encode
    p23 = side[:, :, 0].astype(np.int64)
    scan = None
    while int(p23.max()) > 32 * pw:
        if pw >= bits.PAYLOAD_WORDS:
            raise RuntimeError("granule exceeds the maximum payload row")
        pw = min(bits.PAYLOAD_WORDS, pw + 32)
        scan = scan or scan_tensors()
        side, payload = run_final(pw, *scan)
        p23 = side[:, :, 0].astype(np.int64)
    for retry in range(4):
        bad, limits = resv_guard(p23, nframes, nch, mean_bits, resv_max,
                                 mode_gr)
        if not bad:
            break
        if retry == 3:
            raise RuntimeError(
                "reservoir guard failed on a guaranteed-feasible clamp")
        target, demand = scan or scan_tensors()
        scan = (guard_clamp(target, limits, retry, mean_bits, nch), demand)
        side, payload = run_final(pw, *scan)
        p23 = side[:, :, 0].astype(np.int64)

    return _marshal_and_assemble(cfg, side, payload, nframes,
                                 bits_per_frame, mean_bits, resv_max, sfb_s,
                                 scfsi=scfsi_frames)
