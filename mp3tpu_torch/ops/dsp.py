"""DSP front end in PyTorch (port of mp3tpu/ops/jaxdsp.py): polyphase
analysis and MDCT as batched float32 matmuls over the granule axis.

The sliding 512-sample analysis windows are ``Tensor.unfold`` views;
the JAX package built them from strided slices only to avoid slow
gathers on the TPU.  The Layer III functions work on a batch of lanes
(a leading axis L), each product through ``lanes.mm``.
"""
import numpy as np
import torch

from ..tables import dsp as T
from . import graphs, lanes

SIGN = np.ones((18, 32))
SIGN[1::2, 1::2] = -1.0

# constants with the j = 511 - i window reversal folded in
ENWINDOW_REV = T.ENWINDOW[::-1].copy()
ANA_FILTER_REV = T.ANA_FILTER[:, ::-1].copy()


def _alias_matrix():
    """Aliasing butterflies (mdct.c:83-91) as one (576, 576) linear map
    on the per-granule (32 band, 18 line) spectrum."""
    A = np.eye(576)
    for band in range(31):
        for k in range(8):
            i_lo = band * 18 + (17 - k)
            i_hi = (band + 1) * 18 + k
            rl = A[i_lo].copy()
            rh = A[i_hi].copy()
            A[i_lo] = rl * T.ALIAS_CS[k] + rh * T.ALIAS_CA[k]
            A[i_hi] = rh * T.ALIAS_CS[k] - rl * T.ALIAS_CA[k]
    return A


def _short_basis():
    """(36, 18) combined map: in36 -> interleaved short MDCT output."""
    B = np.zeros((36, 18))
    for w in range(3):
        for m in range(6):
            for k in range(12):
                B[k + 6 * w + 6, 3 * m + w] += T.MDCT_WIN[2][k] * T.COS_S[m, k]
    return B


ALIAS = _alias_matrix()
BASIS_LONG = {b: (T.MDCT_WIN[b][:, None] * T.COS_L.T) for b in (0, 1, 3)}
BASIS_SHORT = _short_basis()


def numpy_constants():
    """The numpy constants this module's tensors are made from, under the
    JAX package's names (jaxdsp._ENWINDOW_REV, ...)."""
    return dict(enwindow_rev=ENWINDOW_REV, ana_filter_rev=ANA_FILTER_REV,
                basis_long=BASIS_LONG, basis_short=BASIS_SHORT,
                alias=ALIAS)


def device_tables(c, device):
    """float32 tensors on `device` from ``numpy_constants()``-shaped `c`;
    equal constants on one device give the same tensors
    (``graphs.shared_tensors``)."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return graphs.shared_tensors(dict(
        enwindow_rev=f(c["enwindow_rev"]),
        ana_filter_rev_t=f(np.asarray(c["ana_filter_rev"]).T),
        basis_long=f(np.stack([c["basis_long"][b] for b in (0, 1, 3)])),
        basis_short=f(c["basis_short"]),
        alias_t=f(np.asarray(c["alias"]).T),
        sign=f(SIGN)), device)


def polyphase(flat, DT):
    """Polyphase analysis of float32 sample streams (..., n) whose first
    512 samples are history: one (32,) subband vector per 32 new
    samples, (..., n / 32 - 16, 32).  A leading axis is a lane axis."""
    # W[..., t, j] = flat[..., 32 (t + 1) + j]: the reference window
    # z[t, 511 - j]
    W = flat[..., 32:].unfold(-1, 512, 32)
    v = W * DT["enwindow_rev"]
    y = v.reshape(v.shape[:-1] + (8, 64)).sum(dim=-2)
    if y.dim() == 2:
        return y @ DT["ana_filter_rev_t"]
    return lanes.mm(y, DT["ana_filter_rev_t"], "polyphase")


def subband_granules(blocks, prev_tail, DT):
    """Polyphase analysis for a batch of granules of each lane.

    blocks (L, G, 576) scaled samples (x/32768); prev_tail (L, 512) the
    samples preceding blocks[:, 0].  Returns (L, G, 18, 32) subband
    samples.  One lane may come without its lane axis."""
    G = blocks.shape[-2]
    flat = torch.cat([prev_tail.to(torch.float32),
                      blocks.reshape(blocks.shape[:-2] + (-1,))
                      .to(torch.float32)], dim=-1)
    return polyphase(flat, DT).reshape(blocks.shape[:-2] + (G, 18, 32))


def mdct_granules(sb, sb_prev_last, block_type, DT):
    """Batched MDCT.  sb (L, G, 18, 32); sb_prev_last (L, 18, 32) the
    granule before sb[:, 0]; block_type (L, G).  Returns xr (L, G, 576).
    One lane may come without its lane axis."""
    if sb.dim() == 3:
        return mdct_granules(sb[None], sb_prev_last[None], block_type[None],
                             DT)[0]
    L, G = sb.shape[:2]
    sign = DT["sign"]
    sbf = sb.to(torch.float32) * sign
    prevf = torch.cat([(sb_prev_last.to(torch.float32) * sign)[:, None],
                       sbf[:, :-1]], dim=1)
    x = torch.cat([prevf, sbf], dim=2).transpose(-1, -2)  # (L, G, 32, 36)
    outs = [lanes.mm(x, DT["basis_long"][i], f"mdct_long{b}")
            for i, b in enumerate((0, 1, 3))]
    out_short = lanes.mm(x, DT["basis_short"], "mdct_short")
    bt = block_type[..., None, None]
    out = torch.where(bt == 0, outs[0],
                      torch.where(bt == 1, outs[1],
                                  torch.where(bt == 3, outs[2], out_short)))
    xr = out.reshape(L, G, 576)
    xr_alias = lanes.mm(xr, DT["alias_t"], "alias")
    return torch.where((block_type == 2)[..., None], xr, xr_alias)
