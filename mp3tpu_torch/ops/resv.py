"""Bit-reservoir budget scan (port of mp3tpu/ops/jaxresv.py).

The scan is serial over frames with a one-integer carry, so it runs on
the host through the shared native scan
(``runtime.bitstream.resv_scan``, reservoir.c:101-134 policy),
which tests/test_jaxresv.py holds equal to the JAX scan.  On a CUDA
device this costs one device->host copy of (pe, demand) per segment.
pe enters the scan as float64.
"""
import numpy as np
import torch

from ..runtime.bitstream import resv_scan
from ..runtime.profiling import span


def granule_major(x, nch, mode_gr):
    """(nch, G) -> (F, R) with r = gr*nch + ch (the scan's order)."""
    G = x.shape[1]
    F = G // mode_gr
    return x.reshape(nch, F, mode_gr).permute(1, 2, 0) \
        .reshape(F, mode_gr * nch)


def from_granule_major(x, nch, mode_gr):
    """(F, R) -> (nch, G)."""
    F = x.shape[0]
    return x.reshape(F, mode_gr, nch).permute(2, 0, 1) \
        .reshape(nch, F * mode_gr)


def _native(pe, demand, size, mean_bits, resv_max, mode_gr, nch, delta):
    """Native scan over granule-major numpy frames; returns
    (budgets (F, R) int64, size_out)."""
    F = pe.shape[0]
    to_ch = lambda a: a.reshape(F, mode_gr, nch).transpose(2, 0, 1) \
        .reshape(nch, F * mode_gr)  # noqa: E731
    bud, size = resv_scan(to_ch(pe), to_ch(demand), None, None, F, nch,
                          mean_bits, resv_max, mode_gr, delta=delta,
                          size=size)
    return bud.reshape(nch, F, mode_gr).transpose(1, 2, 0) \
        .reshape(F, mode_gr * nch), size


@span("scan_budgets")
def scan_budgets(pe, demand, size0, mean_bits, resv_max, mode_gr, nch,
                 delta, valid=None):
    """pe, demand: (F, R) granule-major float/int tensors; size0: the
    carried reservoir level (int or 0-d tensor); valid: optional (F,)
    bool -- False frames are bucket padding and leave the level as it
    was.  Returns (budgets (F, R) int32 on pe's device, size_out int)."""
    dev = pe.device
    pe_h = pe.detach().to("cpu", torch.float64).numpy()
    dm_h = demand.detach().to("cpu", torch.int64).numpy()
    F = pe_h.shape[0]
    ok = (np.ones(F, bool) if valid is None
          else valid.detach().to("cpu").numpy().astype(bool))
    size = int(size0)
    budgets = np.zeros((F, mode_gr * nch), np.int64)
    f = 0
    while f < F:
        if ok[f]:
            e = f
            while e < F and ok[e]:
                e += 1
            budgets[f:e], size = _native(pe_h[f:e], dm_h[f:e], size,
                                         mean_bits, resv_max, mode_gr, nch,
                                         delta)
        else:
            # a padded frame is scanned from the carried level, which it
            # then leaves untouched
            e = f + 1
            budgets[f:e], _ = _native(pe_h[f:e], dm_h[f:e], size, mean_bits,
                                      resv_max, mode_gr, nch, delta)
        f = e
    return torch.as_tensor(budgets, dtype=torch.int32, device=dev), size


def scan_budgets_batched(pe, demand, size0, mean_bits, resv_max, mode_gr,
                         nch, delta):
    """Clip-batched scan of the corpus path: pe, demand (B, F, R)
    granule-major tensors, size0 (B,) carried levels.  One copy of the
    inputs to the host, then B native scans.  Returns (budgets (B, F, R)
    int32, size_out (B,) int32), both on pe's device."""
    dev = pe.device
    pe_h = pe.detach().to("cpu", torch.float64).numpy()
    dm_h = demand.detach().to("cpu", torch.int64).numpy()
    s0 = torch.as_tensor(size0).to("cpu", torch.int64).numpy()
    budgets = np.zeros(pe_h.shape, np.int64)
    sizes = np.zeros(len(s0), np.int64)
    for b in range(len(s0)):
        budgets[b], sizes[b] = _native(pe_h[b], dm_h[b], int(s0[b]),
                                       mean_bits, resv_max, mode_gr, nch,
                                       delta)
    return (torch.as_tensor(budgets, dtype=torch.int32, device=dev),
            torch.as_tensor(sizes, dtype=torch.int32, device=dev))
