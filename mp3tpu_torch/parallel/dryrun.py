"""Both multi-rank paths on a small input (port of
``__graft_entry__.dryrun_multichip``)."""
import numpy as np
import torch

from ..config import EncoderConfig
from ..tables import mpeg
from .clip import encode_layer3_sharded
from .sharding import encode_sharded, make_mesh


def dryrun_multichip(n_devices, device):
    """Run, on each of the n_devices ranks of the initialized default
    process group, computing on `device`:

    1. ``encode_sharded``: granule-axis sharding with the all-gathered
       4-block halo and the all-reduced demand;
    2. ``encode_layer3_sharded``: the clip -> bytes path, chunk-sharded
       analysis and rate loop with the block-type automaton composed
       from all-gathered maps, host reservoir scan, gathered final
       encode and native assembly.

    The exchanged tensors travel on `device`'s type.  Raises unless the
    stream starts with a sync word.  Returns the stream."""
    dev = torch.device(device)
    mesh = make_mesh(dev.type, n_devices)
    G = 8 * n_devices
    rng = np.random.RandomState(0)
    blocks = (rng.randn(G, 576) * 3000).astype(np.float32)
    budget = np.full(G, 900.0, np.float32)
    out = encode_sharded(mesh, blocks, budget, 1, 0, dev)
    if int(out["total_demand"][0]) != int(out["part2_3_length"].sum()):
        raise RuntimeError("encode_sharded: the all-reduced demand is not "
                           "the sum of the granules' part2_3_length")

    pcm = (rng.randn(2, G * 576) * 2500).astype(np.int16)
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100)
    mp3 = encode_layer3_sharded(pcm, cfg, dev, mesh=mesh, chunk=8)
    if not (len(mp3) > 400 and mp3[0] == 0xFF
            and (mp3[1] & 0xF0) == 0xF0):
        raise RuntimeError(f"dryrun stream of {len(mp3)} bytes has no sync "
                           "word")
    return mp3
