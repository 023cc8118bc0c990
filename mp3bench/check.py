"""The comparison that decides ``correct``.

The window's streams are judged by the plain reference of ``ref/``
against the PCM that the benchmark made, after the window has closed:
a sample of the jobs, drawn from the seed with the longest kind in it,
and in each sampled stream every frame's structure and a sample of its
frames in depth.  Two numbers are compared, each against the limit that
the configuration's file states under ``limits``:

- ``bad_frames``: frames with a structural fault (header, size, side
  info, window sequence, reservoir, Huffman codes or part2_3_length on
  Layer III; header, size, CRC, ancillary bits, code ranges or an
  allocation left unfilled on Layer II).  An exact comparison: limit 0.
- ``mismatch_ppm``: of the quantized values (Layer III: every line of
  every sampled granule, sign included; Layer II: every scfsi, scale
  factor and sample code of every allocated subband), the share in
  parts per million that differs from what the reference derives from
  the PCM in float64 under the stream's own decisions (block types,
  gains and scale factors; the allocation and joint-stereo bound).

``control=True`` puts the reference, computed in bfloat16, in the
program's place: the elements it derives are judged against the
float64 reference's, on the same frames and decisions.
"""
import numpy as np
import torch

from .ref import layer2 as R2
from .ref import layer3 as R3

#: the analysis runs in blocks of this many granules or frames
BLOCK = 256
#: numbers judged by the worst stream of the sample
WORST = ("silenced_pct", "unspent_pct")
#: a granule is silenced where the stream's lines leave this share of the
#: PCM's energy there, or more, as noise
SILENCED = 0.9


def _blocks(idx):
    for i in range(0, len(idx), BLOCK):
        yield idx[i:i + BLOCK]


def _judge_layer3(config, pcm, stream, frames_to_check, dtype, rng):
    frames, faults = R3.structure(stream, config, pcm.shape[1],
                                  config.get("padding", False))
    out = dict(bad_frames=len(faults), compared=0, mismatched=0,
               granules=0, short=0, faults=faults[:3])
    if not frames:
        return out
    out["unspent_pct"] = unspent_pct(frames)
    bts = np.array([[gi["block_type"] for gi in gr]
                    for fr in frames for gr in fr["si"]["gr"]])
    out["granules"], out["short"] = bts.size, int((bts == R3.SHORT).sum())
    pick = np.sort(rng.choice(len(frames), min(frames_to_check, len(frames)),
                              replace=False))
    grans = []
    for f in pick:
        try:
            grans += R3.decode_frame(stream, frames, int(f),
                                     config["sample_rate_hz"])
        except ValueError as e:
            out["bad_frames"] += 1
            out["faults"].append(f"frame {f}: {e}")
    rate = config["sample_rate_hz"]
    heard_grans = silenced = 0
    for ch in range(pcm.shape[0]):
        gs = [g for g in grans if g[1] == ch]
        for blk in _blocks(gs):
            xr64 = R3.analysis(pcm[ch], [g[0] for g in blk],
                               [g[2]["block_type"] for g in blk])
            want = R3.requantize(xr64, blk, rate)
            if dtype == torch.float64:
                got = np.stack([g[5] for g in blk])
                miss = (np.abs(got) != want) | (
                    (got != 0) & (np.sign(got) != np.sign(xr64.numpy())))
                heard = R3.dequantize(blk, rate)
            else:
                xr = R3.analysis(pcm[ch], [g[0] for g in blk],
                                 [g[2]["block_type"] for g in blk], dtype)
                got = R3.requantize(xr, blk, rate, dtype)
                sign = np.sign(xr.to(torch.float64).numpy())
                miss = (got != want) | ((want != 0) & (
                    sign != np.sign(xr64.numpy())))
                heard = R3.dequantize([g[:5] + (row,) for g, row in
                                       zip(blk, sign * got)], rate)
            out["compared"] += miss.size
            out["mismatched"] += int(miss.sum())
            signal = (xr64.numpy() ** 2).sum(1)
            noise = ((xr64.numpy() - heard) ** 2).sum(1)
            heard_grans += int((signal > 0).sum())
            silenced += int(((signal > 0) & (noise >= SILENCED * signal))
                            .sum())
    if heard_grans:
        out["silenced_pct"] = 100.0 * silenced / heard_grans
    return out


def unspent_pct(frames):
    """Of a Layer III stream's main-data bytes, the share that no
    granule's data holds and that the next frame's main data skips
    (stuffing): a rate loop that spends the bits each granule is given
    leaves bytes unspent only where the reservoir is full.  The
    reservoir left after the last frame is not counted."""
    gap = 0
    for a, b in zip(frames, frames[1:]):
        gap += b["md_start"] - -(-(8 * a["md_start"] + a["md_bits"]) // 8)
    return 100.0 * gap / sum(f["own"] for f in frames)


def _judge_layer2(config, pcm, stream, frames_to_check, dtype, rng):
    n, faults = R2.structure(stream, config, pcm.shape[1])
    out = dict(bad_frames=len(faults), compared=0, mismatched=0,
               faults=faults[:3])
    if faults:
        return out
    data = np.frombuffer(bytes(stream), np.uint8)
    pick = np.sort(rng.choice(n, min(frames_to_check, n), replace=False))
    parsed = []
    for f in pick:
        p = R2.parse_frame(data, config, int(f))
        if p["faults"]:
            out["bad_frames"] += 1
            out["faults"] += p["faults"][:1]
        else:
            parsed.append((int(f), p))
    for blk in _blocks(parsed):
        fr = [f for f, _ in blk]
        sb64 = torch.stack([R2.subbands(pcm[ch], fr)
                            for ch in range(pcm.shape[0])], 1)
        sb = sb64 if dtype == torch.float64 else torch.stack(
            [R2.subbands(pcm[ch], fr, dtype) for ch in range(pcm.shape[0])], 1)
        for i, (_, p) in enumerate(blk):
            want = R2.elements(sb64[i], p)
            got = (p["scfsi"], p["sf"], p["codes"]) \
                if dtype == torch.float64 else R2.elements(sb[i], p, dtype)
            on = p["ba"] > 0
            for w, g in zip(want, got):
                m = (w != g)
                if m.ndim == 4:                      # codes (2, 3, 12, 32)
                    m = m.transpose(0, 3, 1, 2)
                out["compared"] += int(m[on].size)
                out["mismatched"] += int(m[on].sum())
    return out


def judge(config, pairs, frames_to_check, seed, control=False):
    """Judge [(pcm (nch, n) int16, stream bytes)]: {"bad_frames",
    "mismatch_ppm", "compared", "faults", ...} summed over the pairs;
    `frames_to_check` frames of each stream in depth, drawn from
    `seed`."""
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if control else torch.float64
    one = _judge_layer3 if config["layer"] == 3 else _judge_layer2
    tot = dict(bad_frames=0, compared=0, mismatched=0, granules=0, short=0,
               faults=[])
    for pcm, stream in pairs:
        r = one(config, pcm, stream, frames_to_check, dtype, rng)
        for k in ("bad_frames", "compared", "mismatched", "granules",
                  "short"):
            tot[k] += r.get(k, 0)
        tot["faults"] += r["faults"]
        for k in WORST:                      # the worst stream's
            if k in r:
                tot[k] = max(tot.get(k, r[k]), r[k])
    tot["mismatch_ppm"] = (1e6 * tot["mismatched"] / tot["compared"]
                           if tot["compared"] else None)
    tot["faults"] = tot["faults"][:5]
    return tot


def verdict(result, limits):
    """(correct, [(name, value, limit)]) of a ``judge`` result under the
    configuration's limits, one row a limit, in the limits' order.
    Nothing compared is not correct."""
    rows = [(n, result.get(n), lim) for n, lim in limits.items()]
    ok = all(v is not None and lim is not None and v <= lim
             for _, v, lim in rows)
    return ok, rows
