"""Multi-rank Layer III clip -> MP3 bytes over a device mesh (port of
mp3tpu/parallel/clip.py).

The clip becomes a grid of fixed-size granule chunks, laid out
contiguously over the mesh's ranks.  Each chunk carries the 4 PCM blocks
before it, sliced on the host, so the carried DSP/psy state needs no
traffic between ranks.  The two sequential pieces are:

  - the block-type automaton: each rank composes its chunks' transition
    maps (``ops/psy.fsm_maps``/``fsm_compose``/``fsm_prefix``), the maps
    are all-gathered, and every rank composes the global prefix and its
    chunks' initial states, so block types equal the sequential scan's.
    The JAX package compiles the analysis around that exchange as one
    ``shard_map`` program; on the card the rank's chunk lanes run as two
    CUDA graphs in one batch, psy with the maps (stage "sharded_psy")
    and the spectra with scfsi (stage "sharded_spectra"), the
    all-gather between them on the caller's stream (``GRAPHS``);
  - the bit reservoir: pe and demand are all-gathered and every rank
    runs the same native scan on the host, as the JAX package does
    (``mp3tpu/parallel/clip.py:260-263``), behind one download counted
    in ``resv.host_scans``.

The final encode emits full ``PAYLOAD_WORDS`` rows; side and payload are
all-gathered and come to the host in one download (``encoder.fetches``),
and every rank runs the guard and the native assembler and returns the
same bytes.  Each stage's arrays travel in one gather and one download,
as the JAX package reads them in one ``jax.device_get`` a stage
(``mp3tpu/parallel/clip.py:233``, ``:276``).
"""
import numpy as np
import torch
import torch.distributed as dist

from .. import encoder
from ..encoder import RELAX_DELTA, Download, _chunk_size, _Layer3Framing
from ..models.layer3 import _scfsi_flags
from ..ops import bits, graphs, loop, psy
from ..runtime.profiling import scope
from ..runtime.bitstream import (NativeAssembler, guard_clamp, resv_guard,
                                 resv_scan)
from ..tables import mpeg
from .sharding import all_gather_cat, make_mesh

#: the process's captured analysis graphs (``graphs.GraphCache``), two a
#: clip layout: psy and the spectra, each keyed on the lanes' layout
#: (Kl, nch, C), the rank and world size and the tables.  A 60 s stereo
#: clip at world 1 (36 lanes of 258 blocks) holds 21.4 MB of static
#: input a graph, and the spectra's 21.2 MB of spectrum out; the
#: temporaries live in the device's one graph pool.  8 keys hold 4 clip
#: layouts.  A dropped key synchronizes the card (``graphs.on_stream``),
#: and its next call runs eagerly and captures again (capture times:
#: PERF.md §7).
GRAPHS = graphs.GraphCache(8)


def _chunk_maps(attack, PT):
    """Each lane's automaton maps (L, C) -> (L, 4), composed over its
    chunk."""
    return psy.fsm_prefix(psy.fsm_maps(attack, PT).transpose(0, 1))[-1]


def _inits(allmaps, rank, Kl):
    """The global prefix of every chunk's maps (K, nch, 4), gathered in
    rank order: rank `rank`'s Kl chunks' initial states (Kl*nch,)."""
    pref = psy.fsm_prefix(allmaps)
    inits = torch.cat([torch.zeros_like(pref[:1, :, 0]), pref[:-1, :, 0]])
    return inits[rank * Kl:][:Kl].reshape(-1)


def _initial_states(PT, attack, mesh, Kl, nch):
    """The global automaton: each lane's maps (attack (Kl*nch, C), lanes
    chunk-major) composed over its chunk, all-gathered, composed over
    the chunks; returns this rank's chunks' initial states (Kl*nch,)."""
    allmaps = all_gather_cat(mesh, _chunk_maps(attack, PT).reshape(Kl, nch,
                                                                   4))
    return _inits(allmaps, mesh.get_local_rank("frames"), Kl)


def _psy_maps(enc, ext, halo):
    """The first graph's body: psy of the rank's lanes in one batch, ext
    (L, C+2, 576), halo (L, 2, 576), and each lane's composed automaton
    maps (L, 4).  Builds no tensor from host data and reads none back."""
    PT = enc.tables("psy")
    p = psy.psycho_granules(ext, halo, PT, warmup=2)
    return dict(ratio_l=p["ratio_l"], ratio_s=p["ratio_s"], pe=p["pe"],
                attack=p["attack"], maps=_chunk_maps(p["attack"], PT))


def _spectra(enc, ext, attack, ratio_l, ratio_s, allmaps, rank, Kl):
    """The second graph's body: from the gathered maps (K, nch, 4) this
    rank's initial states, its lanes' block types, spectra and (MPEG-1)
    scfsi flags.  Builds no tensor from host data and reads none back."""
    PT, ST = enc.tables("psy"), enc.tables("st")
    bt = psy._fsm_blocktype(attack, _inits(allmaps, rank, Kl), PT)[0]
    res = dict(xr=enc.spectrum(ext, bt), block_type=bt)
    if not ST["lsf"]:
        res["scfsi"] = _scfsi_flags(res["xr"], ratio_l, ratio_s, bt, ST,
                                    enc.tables("l3"))
    return res


def _captured_lanes(enc, ext, halo, mesh, Kl, nch, record, on_stream):
    """``_lanes``' host side: `record` captures a graph (CUDA:
    ``graphs.cuda_graph``) and ``on_stream(body, keep)`` runs a graph's
    host side (CUDA: ``graphs.on_stream`` on the graph stream, under its
    lock); what crosses from one graph to the other is a clone.  Returns
    (L, C, ...) tensors."""
    rank, world = mesh.get_local_rank("frames"), mesh.size()
    layout = dict(Kl=Kl, nch=nch, C=ext.shape[1] - 2, rank=rank, world=world)
    PT = enc.tables("psy")
    tables = (PT, enc.tables("st"), enc.tables("dsp"), enc.tables("l3"))

    def run(stage, inputs, fn, tables):
        key = (stage, graphs.key_of(inputs, layout, *tables))
        return on_stream(
            lambda: graphs.run(GRAPHS, key, stage, inputs, fn, record,
                               refs=tables),
            lambda entry: {k: v.clone()
                           for k, v in entry.outputs[stage].items()})

    p = run("sharded_psy", dict(ext=ext, halo=halo),
            lambda i: _psy_maps(enc, i["ext"], i["halo"]), (PT,))
    allmaps = all_gather_cat(mesh, p["maps"].reshape(Kl, nch, 4))
    s = run("sharded_spectra",
            dict(ext=ext, attack=p["attack"], ratio_l=p["ratio_l"],
                 ratio_s=p["ratio_s"], allmaps=allmaps),
            lambda i: _spectra(enc, i["ext"], i["attack"], i["ratio_l"],
                               i["ratio_s"], i["allmaps"], rank, Kl), tables)
    return dict(s, ratio_l=p["ratio_l"], ratio_s=p["ratio_s"], pe=p["pe"])


def _lanes(enc, ext, halo, mesh, Kl, nch):
    """psy, the global automaton, spectra and (MPEG-1) scfsi of the
    rank's Kl*nch chunk lanes in one batch on the card: ext (L, C+2,
    576), halo (L, 2, 576) CUDA tensors, as two CUDA graphs replayed
    around the maps' all-gather.  Returns (L, C, ...) tensors."""
    dev = ext.device
    return _captured_lanes(
        enc, ext, halo, mesh, Kl, nch, graphs.cuda_graph(dev),
        lambda body, keep: graphs.on_stream(dev, body, keep))


def _per_lane(enc, ext, halo, mesh, Kl, nch):
    """``_lanes`` lane by lane, op by op: what the CPU runs, and on the
    card the yardstick of the captured form."""
    PT, ST = enc.tables("psy"), enc.tables("st")
    L = ext.shape[0]
    ps = [psy.psycho_granules(ext[i], halo[i], PT, warmup=2)
          for i in range(L)]
    attack = torch.stack([p["attack"] for p in ps])
    init = _initial_states(PT, attack, mesh, Kl, nch)
    bt = torch.stack([psy._fsm_blocktype(attack[i], init[i], PT)[0]
                      for i in range(L)])
    res = {k: torch.stack([p[k] for p in ps])
           for k in ("ratio_l", "ratio_s", "pe")}
    res.update(xr=torch.stack([enc.spectrum(ext[i], bt[i])
                               for i in range(L)]), block_type=bt)
    if not ST["lsf"]:
        res["scfsi"] = torch.stack([_scfsi_flags(
            res["xr"][i], res["ratio_l"][i], res["ratio_s"][i], bt[i], ST,
            enc.tables("l3")) for i in range(L)])
    return res


def _analyze(L3, blocks, halo4, mesh):
    """This rank's chunks (Kl, nch, C, 576) and their halos (Kl, nch, 4,
    576), int16-valued: psy, the global automaton, spectra and the demand encode, the
    Kl*nch lanes in one batch on a CUDA tensor (``_lanes``), lane by
    lane on any other (``_per_lane``).  Returns the rank's tensors, lane
    order (chunk, channel, granule)."""
    enc, dev = L3.enc, L3.dev
    Kl, nch, C = blocks.shape[:3]
    ST = enc.tables("st")
    ext = torch.cat([halo4[:, :, 2:], blocks], dim=2) \
        .reshape(Kl * nch, C + 2, 576).to(torch.float32)
    halo = halo4[:, :, :2].reshape(Kl * nch, 2, 576).to(torch.float32)
    batch = _lanes if dev.type == "cuda" else _per_lane
    a = batch(enc, ext, halo, mesh, Kl, nch)
    N = Kl * nch * C
    res = dict(xr=a["xr"].reshape(N, 576),
               ratio_l=a["ratio_l"].reshape(N, 21),
               ratio_s=a["ratio_s"].reshape(N, 12, 3),
               block_type=a["block_type"].reshape(N),
               pe=a["pe"].reshape(Kl, nch, C))
    out = loop.outer_loop(res["xr"], torch.full((N,), 4095.0, device=dev),
                          res["ratio_l"], res["ratio_s"],
                          res["block_type"] != mpeg.NORM_TYPE,
                          res["block_type"], ST)
    res["p23"] = out["part2_3_length"].reshape(Kl, nch, C)
    res["qss"] = out["qss0"].to(torch.float32)
    if not ST["lsf"]:
        # scfsi pairs never straddle chunks (C even)
        res["scfsi"] = a["scfsi"]
        res["sf_fix"] = out["sf_l"].reshape(Kl * nch, C, 21)[:, 0::2] \
            .to(torch.int8)
    return res


def encode_layer3_sharded(pcm, cfg, device, mesh=None, chunk=None):
    """Encode int16 PCM to Layer III bytes over the ranks of `mesh`
    (default: the whole default process group, on `device`'s type), each
    rank computing its chunks on `device`.  Every rank passes the same PCM
    and returns the same bytes.

    Semantics match ``encode_layer3_fast`` (same analysis, rate loop,
    reservoir scan and assembler); the chunk grid (C = `chunk`, default
    the bucket covering a rank's share) is padded so that every rank
    carries the same number of chunks."""
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
    flat = np.empty((nch, Gp, 576), np.int16)
    encoder.fill_granules(flat, pcm, 0)
    grid = flat.reshape(nch, K, C, 576).transpose(1, 0, 2, 3)
    halo4 = np.zeros((K, nch, 4, 576), np.int16)
    for k in range(1, K):
        halo4[k] = flat[:, k * C - 4: k * C]
    lo = mesh.get_local_rank("frames") * Kl

    def mine(a, dtype):
        """This rank's share of a host array, through a pinned buffer."""
        return encoder._to_device(a[lo:lo + Kl], dtype, dev)

    def fetch(parts, scan=False):
        """The gathered (K, ...) numpy arrays of this rank's `parts` (a
        dict of (Kl, ...) float32 or integer tensors) in one all-gather,
        one queued download (``queue_download``) and one wait: a host
        scan's inputs (`scan`, counted in ``resv.host_scans``) or results
        (``encoder.fetches``)."""
        layout = [(k, tuple(v.shape)) for k, v in parts.items()]
        flat = torch.cat([
            (v.view(torch.int32) if v.dtype == torch.float32
             else v.to(torch.int32)).reshape(-1) for v in parts.values()])
        got = Download([layout] * D, *encoder.queue_download(
            all_gather_cat(mesh, flat))).wait(scan=scan)
        out = {k: np.concatenate([g[k] for g in got]) for k, _ in layout}
        for k, v in parts.items():
            if v.dtype == torch.float32:
                out[k] = out[k].view(np.float32)
        return out

    with scope("sharded analyze+demand"):
        ana = _analyze(L3, mine(grid, torch.int16), mine(halo4, torch.int16),
                       mesh)
        got = fetch(dict(pe=ana["pe"], p23=ana["p23"], **(
            {"scfsi": ana["scfsi"].reshape(Kl, nch, -1, 4)}
            if mode_gr == 2 else {})), scan=True)

    def to_grid(x):                  # (K, nch, C, ...) -> (nch, G, ...)
        x = np.asarray(x)
        x = x.transpose((1, 0, 2) + tuple(range(3, x.ndim)))
        return x.reshape((nch, Gp) + x.shape[3:])[:, :G]

    if mode_gr == 2:                # (K, nch, C//2, 4) -> (nch, F, 4)
        scfsi_frames = got["scfsi"].transpose(1, 0, 2, 3) \
            .reshape(nch, Gp // 2, 4)[:, :G // 2]
    else:
        scfsi_frames = np.zeros((nch, nframes, 4), np.int32)
    pe = to_grid(got["pe"]).astype(np.float64)
    demand = to_grid(got["p23"]).astype(np.int64)
    target = np.minimum(demand, resv_scan(
        pe, demand, None, None, nframes, nch, L3.mean_bits, L3.resv_max,
        mode_gr, delta=RELAX_DELTA))

    def run_final(target, label):
        with scope(label):
            budget = np.full((nch, Gp), 4095.0, np.float32)
            budget[:, :G] = np.where(target < demand, target, 4095)
            budget = budget.reshape(nch, K, C).transpose(1, 0, 2)
            h = L3.enc.encode_final(
                ana["xr"], ana["ratio_l"], ana["ratio_s"], ana["block_type"],
                mine(budget, torch.float32).reshape(-1),
                payload_words=bits.PAYLOAD_WORDS,
                scfsi=ana.get("scfsi"), sf_fix=ana.get("sf_fix"),
                nch=Kl * nch, qss_lo=ana["qss"])
            got = fetch(dict(side=h["side"].reshape(Kl, nch, C, 19),
                             payload=h["payload"].reshape(Kl, nch, C, -1)))
            return to_grid(got["side"]), to_grid(got["payload"])

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
        encoder.retry_fetches += 1
        side, payload = run_final(target, "sharded final retry")

    with scope("NativeAssembler"):
        asm = NativeAssembler(cfg, L3.sfb_s)
    rows = payload.reshape(nch * G, -1)
    L3.weave(asm, nframes, side,
             (np.ascontiguousarray(rows).reshape(-1),
              np.arange(nch * G, dtype=np.int64) * rows.shape[1]),
             scfsi_frames)
    with scope("NativeAssembler.finish"):
        return asm.finish()
