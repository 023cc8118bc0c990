"""Corpus encoding on PyTorch (port of mp3tpu/parallel/corpus.py).

Clips are independent, so a corpus is data parallel at two levels:

  - on one device, ``encode_corpus_batched`` stacks B clips as B*nch
    channel lanes of one ``Layer3SegmentEncoder``: each launch of the
    analysis' shared stages and of the rate loop covers the whole group,
    the B reservoir scans are one K4 launch (``resv.scan_budgets_batched``),
    the group's segments are all queued before its one download, and
    guard and assembly stay per clip;
  - across processes, ``init_distributed`` joins a ``torch.distributed``
    group and ``local_share`` gives each process a contiguous share of
    the clip list; nothing else crosses processes.

Groups are pipelined as in the JAX package (its loop at
``mp3tpu/parallel/corpus.py:305-316``): ``dispatch_group`` queues a
group's device chain and its download (``_Layer3Framing.fetch_async``,
a copy into pinned memory with an event where the JAX package hands
``jax.device_get`` to a thread), and up to `lookahead` groups are in
flight before ``collect_group`` waits for the oldest and runs its
guard, retries and assembly on the host, while the card works on the
groups queued behind it.  ``lookahead=0`` runs the groups strictly in
order, each collected before the next is framed.
"""
import collections
import numbers
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import EncoderConfig
from ..encoder import (PAYLOAD_WORDS, RELAX_DELTA, _Layer3Framing,
                       _plan_segments, encode_layer3_fast, pinned, upload)
from ..ops import bits, resv
from ..runtime import profiling
from ..runtime.bitstream import NativeAssembler


def init_distributed(coordinator_address, num_processes, process_id,
                     backend):
    """Join the default ``torch.distributed`` process group.

    coordinator_address: "host:port" of rank 0 (read as tcp://) or an
    init URL ("tcp://host:port", "file:///path").  backend: "gloo" (CPU
    tensors) or "nccl" (CUDA tensors, one GPU per rank); there is no
    automatic pick.  Returns (rank, world size)."""
    import torch.distributed as dist

    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def local_share(n_items, process_id=None, num_processes=None):
    """Contiguous [start, end) range of corpus items owned by this
    process (default: this rank of the default group; rank 0 of 1 when
    no group is initialized)."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if joined else 0)
    nproc = num_processes if num_processes is not None else (
        dist.get_world_size() if joined else 1)
    per = -(-n_items // nproc)
    start = min(pid * per, n_items)
    return start, min(start + per, n_items)


def _plan_budgets_corpus(pes, p23s, plan, B, nch, mode_gr, mean_bits,
                         resv_max, delta):
    """Corpus-wide budget assignment: every clip's reservoir scan in one
    batched pass (``resv.scan_budgets_batched``).  pes/p23s: per-segment
    (B*nch*n_pad,) lane tensors.  Returns (per-segment budget rows
    (B*nch*n_pad,) float32, target (B, nch, G) int32, demand (B, nch, G)
    int32), on the inputs' device."""
    pe = torch.cat([p.reshape(B, nch, n_pad)[:, :, :n_real]
                    for (_, n_real, n_pad), p in zip(plan, pes)], dim=2)
    demand = torch.cat([d.reshape(B, nch, n_pad)[:, :, :n_real]
                        for (_, n_real, n_pad), d in zip(plan, p23s)],
                       dim=2).to(torch.int32)
    F = pe.shape[2] // mode_gr

    def gm(x):                        # (B, nch, G) -> (B, F, mode_gr*nch)
        return x.reshape(B, nch, F, mode_gr).permute(0, 2, 3, 1) \
            .reshape(B, F, mode_gr * nch)

    bud, _ = resv.scan_budgets_batched(
        gm(pe), gm(demand), torch.zeros(B, dtype=torch.int32,
                                        device=pe.device),
        mean_bits, resv_max, mode_gr, nch, delta)
    budg = bud.reshape(B, F, mode_gr, nch).permute(0, 3, 1, 2) \
        .reshape(B, nch, F * mode_gr)
    target = torch.minimum(demand, budg)
    rows = []
    for pos, n_real, n_pad in plan:
        t = target[:, :, pos:pos + n_real]
        d = demand[:, :, pos:pos + n_real]
        r = torch.full((B, nch, n_pad), 4095.0, device=pe.device)
        r[:, :, :n_real] = torch.where(t < d, t.to(torch.float32), 4095.0)
        rows.append(r.reshape(-1))
    return tuple(rows), target, demand


def _clip_records(b, G, nch, plan, segs, got, target, demand):
    """Clip b's lanes of a group as the one-shot path's per-segment
    records (plan, segment tensors, fetched results), trimmed to the
    clip's G real granules, for ``_Layer3Framing.settle``.  Tail granules
    past G are not silent (the MDCT overlap rings into the first padded
    granule), so they leave spans and offsets together."""
    cplan, csegs, cgot = [], [], []
    lanes = slice(b * nch, (b + 1) * nch)
    for (pos, n_real, n_pad), a, g in zip(plan, segs, got):
        n = min(n_real, G - pos)
        if n <= 0:
            break
        lo, hi = b * nch * n_pad, (b + 1) * nch * n_pad
        s = {k: a[k][lo:hi] for k in ("xr", "ratio_l", "ratio_s",
                                       "block_type", "qss")}
        s.update((k, a[k][lanes]) for k in ("scfsi", "sf_fix") if k in a)
        s["target"] = target[b, :, pos:pos + n]
        s["demand"] = demand[b, :, pos:pos + n]
        # the clip's words of the group's lane-ordered compacted payload
        wlen = (g["side"][:, 0].astype(np.int64) + 31) >> 5
        start = int(wlen[:lo].sum())
        c = dict(side=g["side"][lo:hi],
                 payload=g["payload"][start:start + int(wlen[lo:hi].sum())])
        if "scfsi" in g:
            c["scfsi"] = g["scfsi"][lanes]
        cplan.append((pos, n, n_pad))
        csegs.append(s)
        cgot.append(c)
    return cplan, csegs, cgot


def dispatch_group(L3, framed, delta, pw, prof):
    """Queue one group of B clips through the segment program as B*nch
    lanes: the block uploads, the analyses, the batched scan, the final
    encodes, then the group's one download.  Nothing waits on the host.
    framed: each clip's (pcm, nframes) from ``L3.frame``.  Returns what
    ``collect_group`` needs: (framed, plan, segment tensors, target,
    demand, the queued ``Download``).

    The group's device tensors stay alive, and unchanged, while later
    groups are queued and replayed: ``settle``'s retries read ``segs``
    and the scan's target and demand.  None of them is a graph's static
    buffer, which a later replay of the same key would overwrite: the
    analysis and the rate loop with its emission hand back clones
    (``models/layer3.py`` ``analysis``, ``ops/loop.py`` ``_graphed``),
    and K4 and ``_plan_budgets_corpus`` make fresh tensors."""
    B, nch, mode_gr, dev = len(framed), L3.nch, L3.mode_gr, L3.dev
    L = B * nch
    G_max = max(nf for _, nf in framed) * mode_gr
    plan = _plan_segments(G_max)
    blocks = np.zeros((L, G_max, 576), np.int16)
    for b, (pcm, nf) in enumerate(framed):
        blocks[b * nch:(b + 1) * nch, :nf * mode_gr] = \
            pcm.reshape(nch, nf * mode_gr, 576)

    segs = []
    fsm = torch.zeros(L, dtype=torch.int32, device=dev)
    with prof.stage("corpus analysis + demand (device)"):
        for pos, n_real, n_pad in plan:
            host = pinned((L, 4 + n_pad, 576), torch.int16, dev)
            bl = host.numpy()
            if pos:
                bl[:, :4] = blocks[:, pos - 4: pos]
            bl[:, 4:4 + n_real] = blocks[:, pos: pos + n_real]
            a = L3.enc.analyze_demand_fused(upload(host, dev), fsm)
            fsm = a["fsm_state"]
            segs.append(a)
    with prof.stage("corpus reservoir scans"):
        rows, target, demand = _plan_budgets_corpus(
            [a["pe"] for a in segs], [a["p23"] for a in segs], plan, B, nch,
            mode_gr, L3.mean_bits, L3.resv_max, delta)
    hs = []
    with prof.stage("corpus final encode + pack (device)"):
        for (pos, n_real, n_pad), a, row in zip(plan, segs, rows):
            cap = bits.payload_cap_words(
                B * n_pad // mode_gr, L3.bits_per_frame, L3.sideinfo_len,
                B * L3.resv_max, L * n_pad)
            h = L3.enc.encode_final(
                a["xr"], a["ratio_l"], a["ratio_s"], a["block_type"], row,
                payload_words=pw, scfsi=a.get("scfsi"),
                sf_fix=a.get("sf_fix"), nch=L, qss_lo=a["qss"],
                flat_cap=cap)
            h.update((k, a[k]) for k in ("scfsi", "n_nonfinite") if k in a)
            hs.append(h)
        download = L3.fetch_async(hs)
    return framed, plan, segs, target, demand, download


def collect_group(L3, cfg, group, pw, prof):
    """The host's side of a group that ``dispatch_group`` queued: the one
    wait for its download, then for each clip the guard and its rare
    retries (``settle``: a retry's final encodes and fetch queue behind
    the groups in flight, which costs a wait but gives the in-order
    bytes) and the native assembly.  Returns the clips' streams."""
    framed, plan, segs, target, demand, download = group
    got = download.wait()
    outs = []
    for b, (_, nf) in enumerate(framed):
        cplan, csegs, cgot = _clip_records(b, nf * L3.mode_gr, L3.nch, plan,
                                           segs, got, target, demand)
        side, payload, _, _, _ = L3.settle(cplan, csegs, cgot, pw, nf, prof)
        with prof.stage("native assembly"):
            asm = NativeAssembler(cfg, L3.sfb_s)
            L3.weave(asm, nf, side, payload, L3.scfsi_frames(cplan, cgot))
            outs.append(asm.finish())
    return outs


def encode_corpus_batched(clips, cfg_kwargs, device, batch=8, prof=None,
                          delta=RELAX_DELTA, pw=PAYLOAD_WORDS, lookahead=3):
    """Encode many independent same-rate Layer III clips on `device` by
    stacking `batch` clips at a time as extra channel lanes of one
    segment program.

    clips: list of (pcm int16, sample_rate_hz); all rates must match.
    cfg_kwargs: ``EncoderConfig`` keyword arguments shared by every clip.
    delta, pw: as in ``encode_layer3_fast``.  lookahead: the groups kept
    in flight (queued, their downloads pending) before the host collects
    the oldest, as the JAX package's ``MP3TPU_CORPUS_LOOKAHEAD`` (default
    3); 0 collects each group before the next is queued.  Every lookahead
    gives the same bytes.  Up to lookahead + 1 groups' segment tensors
    are alive at once.  A clip whose realized bits overdraw the reservoir
    is re-encoded alone at clamped budgets; a clip shorter than its
    group is trimmed to its own frames.
    Returns (outputs in corpus order, stats) like ``encode_corpus``; the
    wall ends with every stream on the host."""
    if isinstance(lookahead, bool) or \
            not isinstance(lookahead, numbers.Integral) or lookahead < 0:
        raise ValueError(f"lookahead must be an integer >= 0, not "
                         f"{lookahead!r}")
    prof = prof if prof is not None else profiling.from_env()
    t0 = time.perf_counter()
    rate = clips[0][1]
    if any(r != rate for _, r in clips):
        raise ValueError("the clips of a batched corpus share one rate")
    cfg = EncoderConfig(sample_rate_hz=rate, **cfg_kwargs)
    L3 = _Layer3Framing(cfg, device)
    outputs, audio_s = [], 0.0
    pending = collections.deque()
    for g0 in range(0, len(clips), batch):
        framed = []
        for pcm, _ in clips[g0:g0 + batch]:
            audio_s += max(np.atleast_2d(pcm).shape) / rate
            framed.append(L3.frame(pcm))
        pending.append(dispatch_group(L3, framed, delta, pw, prof))
        if len(pending) > lookahead:
            outputs += collect_group(L3, cfg, pending.popleft(), pw, prof)
    while pending:
        outputs += collect_group(L3, cfg, pending.popleft(), pw, prof)
    wall = time.perf_counter() - t0
    return outputs, dict(clips=len(clips), audio_s=audio_s, wall_s=wall,
                         x_realtime=audio_s / wall if wall else 0.0)


def encode_corpus(clips, cfg_kwargs, device, encode=None, workers=3):
    """Encode a list of (pcm int16, sample_rate_hz) clips on `device`
    with ``encode(pcm, cfg, device)`` (default ``encode_layer3_fast``);
    returns (outputs in corpus order, stats dict).  cfg_kwargs:
    ``EncoderConfig`` keyword arguments (the rate comes from the clip).
    workers > 1 runs clips on a thread pool, so that one clip's host
    stages (framing, guard, native assembly) overlap another
    clip's device work."""
    encode = encode if encode is not None else encode_layer3_fast

    def one(item):
        pcm, rate = item
        return encode(np.atleast_2d(pcm),
                      EncoderConfig(sample_rate_hz=rate, **cfg_kwargs),
                      device)

    audio_s = sum(max(np.atleast_2d(p).shape) / r for p, r in clips)
    t0 = time.perf_counter()
    if workers > 1 and len(clips) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            outputs = list(ex.map(one, clips))
    else:
        outputs = [one(c) for c in clips]
    wall = time.perf_counter() - t0
    return outputs, dict(clips=len(clips), audio_s=audio_s, wall_s=wall,
                         x_realtime=audio_s / wall if wall else 0.0)
