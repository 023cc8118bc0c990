"""Granule-axis sharding over a device mesh (port of
mp3tpu/parallel/sharding.py).

The reference is strictly sequential; its carried DSP/psy state is a
fixed-size halo at shard boundaries: each shard needs the 4 sample blocks
before its range (2 of psy FFT history, 2 in-batch warmup granules).
Here the granule axis is split contiguously over the ranks of a
one-dimensional ``torch.distributed`` ``DeviceMesh`` (dimension
"frames"): every rank all-gathers the shards' last 4 blocks and takes its
left neighbour's as its halo (rank 0 takes zeros), and the per-shard
demand is summed with ``all_reduce``.

Collectives and devices: the tensors exchanged between ranks travel on
the mesh's device type (gloo carries CPU tensors, NCCL CUDA tensors),
while the compute stays on the caller's `device`.  So one card can hold
the ranks of a "cpu" (gloo) mesh that all compute on it; NCCL takes one
GPU per rank.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..models.layer3 import Layer3SegmentEncoder
from ..ops import loop
from ..tables import mpeg

#: dtypes gloo cannot carry, and the dtype they travel as
_WIRE = {torch.int16: torch.int32}


def make_mesh(device_type, n_devices):
    """One-dimensional DeviceMesh ("frames") over all ranks of the
    initialized default process group, whose backend must carry
    `device_type` tensors (gloo: "cpu", NCCL: "cuda")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "parallel.corpus.init_distributed first")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"a mesh of {n_devices} in a world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, (n_devices,),
                            mesh_dim_names=("frames",))


#: the host's waits in exchanges of card tensors over a host mesh (gloo):
#: each copy of a card tensor down to the exchange
host_exchanges = 0


def all_gather_cat(mesh, t):
    """Every rank's `t` (one shape on all ranks), concatenated along
    dim 0 in rank order, on t's device; exchanged on the mesh's device
    type.  A CUDA tensor over a host mesh passes through the host: its
    download is a wait (counted in ``host_exchanges``), and the result
    goes back up through pinned memory, queued."""
    wire = _WIRE.get(t.dtype, t.dtype)
    x = t.to(device=mesh.device_type, dtype=wire).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group("frames"))
    out = torch.cat(parts).to(dtype=t.dtype)
    if t.device.type == "cuda" and mesh.device_type != "cuda":
        global host_exchanges
        host_exchanges += 1
        out = out.pin_memory()
    return out.to(device=t.device, non_blocking=True)


def encode_sharded(mesh, blocks, budget, version, sampling_frequency,
                   device):
    """Granule-parallel encode of (G, 576) PCM blocks at (G,) bit budgets
    over the mesh; every rank passes the same inputs and computes its
    shard on `device`.  G must divide by the mesh size, with at least 4
    granules a shard.  Returns, on every rank, the whole clip's coding
    decisions (the rate loop's outputs with signed ``ix``, plus ``pe``,
    ``xr`` and the per-rank ``total_demand``), as (G, ...) tensors on
    `device`."""
    dev = torch.device(device)
    n, r = mesh.size(), mesh.get_local_rank("frames")
    G = len(blocks)
    per = G // n
    if per * n != G or per < 4:
        raise ValueError(
            f"encode_sharded needs G divisible by the mesh size with >= 4 "
            f"granules a shard for the 4-block halo (G={G}, {n} ranks); "
            f"use the chunked path (parallel/clip.py)")
    enc = Layer3SegmentEncoder(version, sampling_frequency, dev)
    mine = slice(r * per, (r + 1) * per)
    bl = torch.as_tensor(np.asarray(blocks, np.float32)[mine], device=dev)
    bud = torch.as_tensor(np.asarray(budget, np.float32)[mine], device=dev)
    tails = all_gather_cat(mesh, bl[-4:])
    halo = tails[(r - 1) * 4:r * 4] if r else torch.zeros_like(bl[:4])
    a = enc._analyze_chunk(torch.cat([halo[2:4], bl]), halo[0:2],
                           torch.zeros((), dtype=torch.int32, device=dev))
    xr, bt = a["xr"], a["block_type"]
    out = loop.outer_loop(xr, bud, a["ratio_l"], a["ratio_s"],
                          bt != mpeg.NORM_TYPE, bt, enc.tables("st"))
    # reapply spectrum signs (l3bitstream.c:114-126)
    out["ix"] = torch.where((xr < 0) & (out["ix"] > 0), -out["ix"],
                            out["ix"])
    out["pe"], out["xr"] = a["pe"], xr
    total = out["part2_3_length"].to(torch.int64).sum().reshape(1) \
        .to(mesh.device_type)
    dist.all_reduce(total, group=mesh.get_group("frames"))
    out["total_demand"] = total.to(dev)
    return {k: all_gather_cat(mesh, v) for k, v in out.items()}
