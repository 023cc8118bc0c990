"""Matrix products over a leading lane axis.

The analysis runs on a batch of lanes (channels, or a corpus group's
channels): tensors (L, G, ...), each product (L, ..., K) @ (K, N) one
call for every lane.  It must give what the per-lane analysis gives, bit
for bit (the stream must not change with the layout).  A float32
product over L*G rows can round differently from one over G rows where
the library picks another kernel (a split of the K sum) for the taller
shape; the products named in ``PER_LANE`` run one product a lane
instead, which inside a captured graph costs no host dispatch.
``PRODUCTS`` names every product of the analysis (``ops/psy.py``,
``ops/dsp.py``, the scfsi decision in ``models/layer3.py``).
"""
import torch

#: every product of the analysis, by the name its call site gives it
PRODUCTS = ("dft_c1024", "dft_s1024", "dft_c256", "dft_s256",
            "partition_energy", "partition_tonality", "spread_energy",
            "spread_tonality", "sfb_energy_l", "sfb_threshold_l",
            "partition_energy_s", "spread_energy_s", "sfb_energy_s",
            "sfb_threshold_s", "polyphase", "mdct_long0", "mdct_long1",
            "mdct_long3", "mdct_short", "alias", "scfsi_energy",
            "scfsi_bands")
#: the products that run one product a lane (see the module docstring):
#: all of them.  On an H100 13 of the 22 change an output when batched
#: alone at the main path's 2 x 258 or 2 x 2,050 rows or a corpus group's
#: 32 x 1,026 (both DFTs of each size, the partition sums, the spreading,
#: the long and short sfb sums and the alias butterflies; chip_smoke.py
#: phase 5c); the other 9 agreed there, but the library picks its kernel
#: by shape, and only a product a lane is the per-lane analysis's own call
#: at every segment width and lane count.  The CPU's 1024-point DFT
#: already rounds differently at 4 x 66 rows than at 66.
PER_LANE = frozenset(PRODUCTS)


def mm(x, w, name):
    """x (L, ..., K) @ w (K, N): one product, or one a lane where `name`
    is in ``PER_LANE``."""
    if name in PER_LANE and x.shape[0] > 1:
        return torch.stack([x[i] @ w for i in range(x.shape[0])])
    return x @ w
