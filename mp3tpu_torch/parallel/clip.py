"""Multi-rank Layer III clip -> MP3 bytes over a device mesh (port of
mp3tpu/parallel/clip.py).

The clip becomes a grid of fixed-size granule chunks, laid out
contiguously over the mesh's ranks.  Each chunk carries the 4 PCM blocks
before it, sliced on the host, so the carried DSP/psy state needs no
traffic between ranks.  The two sequential pieces are:

  - the block-type automaton: each rank composes its chunks' transition
    maps (``ops/psy.fsm_maps``/``fsm_compose``/``fsm_prefix``), the maps
    are all-gathered, and every rank composes the global prefix and its
    chunks' initial states, so block types equal the sequential scan's;
  - the bit reservoir: pe and demand are all-gathered and every rank
    runs the same native scan on the host.

The final encode emits full ``PAYLOAD_WORDS`` rows; side and payload are
all-gathered, and every rank runs the guard and the native assembler and
returns the same bytes.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..encoder import RELAX_DELTA, _chunk_size, _Layer3Framing
from ..models.layer3 import _scfsi_flags
from ..ops import bits, loop, psy
from ..runtime import profiling
from ..runtime.bitstream import (NativeAssembler, guard_clamp, resv_guard,
                                 resv_scan)
from ..tables import mpeg
from .sharding import all_gather_cat, make_mesh


def _analyze(L3, blocks, halo4, mesh):
    """This rank's chunks (Kl, nch, C, 576) and their halos (Kl, nch, 4,
    576): psy, the global automaton, spectra and the demand encode.
    Returns the rank's tensors, lane order (chunk, channel, granule)."""
    enc, dev = L3.enc, L3.dev
    Kl, nch, C = blocks.shape[:3]
    PT, ST = enc.tables("psy"), enc.tables("st")
    ext = torch.cat([halo4[:, :, 2:], blocks], dim=2)       # (Kl,nch,C+2,576)
    ps = [[psy.psycho_granules(ext[k, ch], halo4[k, ch, :2], PT, warmup=2)
           for ch in range(nch)] for k in range(Kl)]
    attack = torch.stack([torch.stack([p["attack"] for p in row])
                          for row in ps])                   # (Kl, nch, C)
    maps = psy.fsm_prefix(psy.fsm_maps(attack.reshape(-1))
                          .reshape(Kl * nch, C, 4).transpose(0, 1))[-1]
    allmaps = all_gather_cat(mesh, maps.reshape(Kl, nch, 4))  # (K, nch, 4)
    pref = psy.fsm_prefix(allmaps)
    inits = torch.cat([torch.zeros_like(pref[:1, :, 0]), pref[:-1, :, 0]])
    mine = inits[mesh.get_local_rank("frames") * Kl:][:Kl]    # (Kl, nch)
    bt = torch.stack([torch.stack([
        psy._fsm_blocktype(attack[k, ch], mine[k, ch])[0]
        for ch in range(nch)]) for k in range(Kl)])          # (Kl, nch, C)
    xr = torch.stack([torch.stack([enc.spectrum(ext[k, ch], bt[k, ch])
                                   for ch in range(nch)])
                      for k in range(Kl)])                  # (Kl,nch,C,576)
    N = Kl * nch * C

    def cat(key):
        return torch.stack([torch.stack([p[key] for p in row]) for row in ps])

    res = dict(xr=xr.reshape(N, 576), ratio_l=cat("ratio_l").reshape(N, 21),
               ratio_s=cat("ratio_s").reshape(N, 12, 3),
               block_type=bt.reshape(N), pe=cat("pe"))
    out = loop.outer_loop(res["xr"], torch.full((N,), 4095.0, device=dev),
                          res["ratio_l"], res["ratio_s"],
                          res["block_type"] != mpeg.NORM_TYPE,
                          res["block_type"], ST)
    res["p23"] = out["part2_3_length"].reshape(Kl, nch, C)
    res["qss"] = out["qss0"].to(torch.float32)
    if not ST["lsf"]:
        # scfsi pairs never straddle chunks (C even)
        xr4 = res["xr"].reshape(Kl * nch, C, 576)
        rl = res["ratio_l"].reshape(Kl * nch, C, 21)
        rs = res["ratio_s"].reshape(Kl * nch, C, 12, 3)
        bt2 = bt.reshape(Kl * nch, C)
        res["scfsi"] = torch.stack([_scfsi_flags(xr4[i], rl[i], rs[i],
                                                 bt2[i], ST)
                                    for i in range(Kl * nch)])
        res["sf_fix"] = out["sf_l"].reshape(Kl * nch, C, 21)[:, 0::2] \
            .to(torch.int8)
    return res


def encode_layer3_sharded(pcm, cfg, device, mesh=None, chunk=None,
                          prof=None):
    """Encode int16 PCM to Layer III bytes over the ranks of `mesh`
    (default: the whole default process group, on `device`'s type), each
    rank computing its chunks on `device`.  Every rank passes the same PCM
    and returns the same bytes.

    Semantics match ``encode_layer3_fast`` (same analysis, rate loop,
    reservoir scan and assembler); the chunk grid (C = `chunk`, default
    the bucket covering a rank's share) is padded so that every rank
    carries the same number of chunks."""
    prof = prof if prof is not None else profiling.from_env()
    L3 = _Layer3Framing(cfg, device)
    dev, nch, mode_gr = L3.dev, L3.nch, L3.mode_gr
    if mesh is None:
        mesh = make_mesh(dev.type, dist.get_world_size())
    D = mesh.size()
    pcm, nframes = L3.frame(pcm)
    G = nframes * mode_gr

    C = chunk or _chunk_size(-(-G // D))
    K = -(-(-(-G // C)) // D) * D          # a whole number of chunks a rank
    Kl, Gp = K // D, K * C
    flat = np.zeros((nch, Gp, 576), np.int16)
    flat[:, :G] = pcm.reshape(nch, G, 576)
    grid = flat.reshape(nch, K, C, 576).transpose(1, 0, 2, 3)
    halo4 = np.zeros((K, nch, 4, 576), np.int16)
    for k in range(1, K):
        halo4[k] = flat[:, k * C - 4: k * C]
    lo = mesh.get_local_rank("frames") * Kl

    def mine(a):
        return torch.as_tensor(np.ascontiguousarray(a[lo:lo + Kl]),
                               dtype=torch.float32, device=dev)

    with prof.stage("sharded analysis + demand"):
        ana = _analyze(L3, mine(grid), mine(halo4), mesh)
        pe = all_gather_cat(mesh, ana["pe"]).cpu().numpy()
        p23 = all_gather_cat(mesh, ana["p23"]).cpu().numpy()
        if mode_gr == 2:
            scfsi = all_gather_cat(mesh, ana["scfsi"].reshape(Kl, nch, -1, 4))

    def to_grid(x):                  # (K, nch, C, ...) -> (nch, G, ...)
        x = np.asarray(x)
        x = x.transpose((1, 0, 2) + tuple(range(3, x.ndim)))
        return x.reshape((nch, Gp) + x.shape[3:])[:, :G]

    if mode_gr == 2:                # (K, nch, C//2, 4) -> (nch, F, 4)
        scfsi_frames = scfsi.cpu().numpy().transpose(1, 0, 2, 3) \
            .reshape(nch, Gp // 2, 4)[:, :G // 2]
    else:
        scfsi_frames = np.zeros((nch, nframes, 4), np.int32)
    pe = to_grid(pe).astype(np.float64)
    demand = to_grid(p23).astype(np.int64)
    target = np.minimum(demand, resv_scan(
        pe, demand, None, None, nframes, nch, L3.mean_bits, L3.resv_max,
        mode_gr, delta=RELAX_DELTA))

    def run_final(target, label):
        budget = np.full((nch, Gp), 4095.0, np.float32)
        budget[:, :G] = np.where(target < demand, target, 4095)
        budget = budget.reshape(nch, K, C).transpose(1, 0, 2)
        with prof.stage(label):
            h = L3.enc.encode_final(
                ana["xr"], ana["ratio_l"], ana["ratio_s"], ana["block_type"],
                mine(budget).reshape(-1), payload_words=bits.PAYLOAD_WORDS,
                scfsi=ana.get("scfsi"), sf_fix=ana.get("sf_fix"),
                nch=Kl * nch, qss_lo=ana["qss"])
            side = all_gather_cat(mesh, h["side"].reshape(Kl, nch, C, 19))
            payload = all_gather_cat(
                mesh, h["payload"].to(torch.int32).reshape(Kl, nch, C, -1))
        return to_grid(side.cpu().numpy()), \
            to_grid(payload.cpu().numpy()).view(np.uint32)

    side, payload = run_final(target, "sharded final encode")
    for retry in range(4):
        bad, limits = resv_guard(side[:, :, 0].astype(np.int64), nframes, nch,
                                 L3.mean_bits, L3.resv_max, mode_gr)
        if not bad:
            break
        if retry == 3:
            raise RuntimeError(
                "reservoir guard failed on a guaranteed-feasible clamp")
        target = guard_clamp(target, limits, retry, L3.mean_bits, nch)
        side, payload = run_final(target, "sharded final retry")

    with prof.stage("native assembly"):
        asm = NativeAssembler(cfg, L3.sfb_s)
        rows = payload.reshape(nch * G, -1)
        L3.weave(asm, nframes, side,
                 (np.ascontiguousarray(rows).reshape(-1),
                  np.arange(nch * G, dtype=np.int64) * rows.shape[1]),
                 scfsi_frames)
        return asm.finish()
