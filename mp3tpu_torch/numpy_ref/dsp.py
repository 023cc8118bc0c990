"""Polyphase analysis filterbank and MDCT, stateless batched forms.

The reference carries state in ring buffers (encode.c:292-315) and a
previous-granule save area (mdct.c:99-102).  Both reduce to pure
indexing over the padded sample stream:

  window_subband + filter_subband (encode.c:287-409): at shift t the
  windowed vector is z[i] = x[32t+31-i] * enwindow[i]; the Tavenard
  fold is algebraically the full 32x64 matrix product, which we use.
  Summation order follows the C loops so float64 results match exactly.

  mdct_sub (mdct.c:25-103): each granule's 18x32 subband block is
  sign-compensated once ((-1) for odd band & odd slot, mdct.c:57-60),
  then each band's 36-point input is [previous granule ; current].
"""
import os

import numpy as np

from ..tables import dsp as T


def subband_filter_stream(x, nshifts):
    """All subband samples for one channel stream.

    x: float64 stream of samples already scaled by 1/32768, where
       x[0] is the first input sample; callers pass the full clip.
    nshifts: number of 32-sample shifts to produce (= 18 * granules).

    Returns (nshifts, 32) float64.
    """
    # z windows: pad 512 zeros in front (initial ring buffer state)
    xp = np.concatenate([np.zeros(512), np.asarray(x, np.float64)])
    # gather matrix Z[t, i] = x[32 t + 31 - i] = xp[512 + 32t + 31 - i]
    t = np.arange(nshifts)[:, None]
    i = np.arange(512)[None, :]
    Z = xp[512 + 32 * t + 31 - i] * T.ENWINDOW[None, :]
    # y[k] = sum_r z[k + 64 r], C order r ascending (encode.c:392-396)
    Zr = Z.reshape(nshifts, 8, 64)
    y = Zr[:, 0, :].copy()
    for r in range(1, 8):
        y += Zr[:, r, :]
    # s = M @ y with the fold's exact accumulation order (encode.c:399-408)
    M = T.ANA_FILTER
    ysum = np.empty((nshifts, 16))
    ysub = np.empty((nshifts, 15))
    for j in range(16):
        ysum[:, j] = y[:, j] + y[:, 32 - j]
    for j in range(15):
        ysub[:, j] = y[:, 33 + j] - y[:, 63 - j]
    s = np.repeat(y[:, 16:17], 32, axis=1).copy()
    for j in range(16):
        s += M[None, :, j] * ysum[:, j:j + 1]
    for j in range(15):
        s += M[None, :, 33 + j] * ysub[:, j:j + 1]
    return s


def granule_subbands(x, ngranules):
    """(ngranules, 18, 32) subband samples for one channel stream."""
    s = subband_filter_stream(x, 18 * ngranules)
    return s.reshape(ngranules, 18, 32)


_SIGN = np.ones((18, 32))
_SIGN[1::2, 1::2] = -1.0  # odd slot & odd band compensation (mdct.c:57-60)

_UNROLL = np.load(os.path.join(os.path.dirname(T.__file__), "data", "mdct_unroll.npz"))


def _mdct_long_unrolled(fin):
    """Evaluate the reference's unrolled 36->18 MDCT (mdct.c:199-509).

    fin: (..., 36) windowed inputs.  Statement/term tables parsed from
    the reference source by tools/parse_mdct_unroll.py.
    """
    sm = _UNROLL["stmt_m"]; cs = _UNROLL["stmt_cos_sign"]
    ck = _UNROLL["stmt_cos_k"]; off = _UNROLL["stmt_term_off"]
    tsg = _UNROLL["term_sign"]; tix = _UNROLL["term_idx"]
    out = np.zeros(fin.shape[:-1] + (18,))
    for s in range(len(sm)):
        terms = slice(off[s], off[s + 1])
        signs = tsg[terms]; idxs = tix[terms]
        acc = signs[0] * fin[..., idxs[0]]
        for sign, i in zip(signs[1:], idxs[1:]):
            acc = acc + sign * fin[..., i]
        m = int(sm[s])
        out[..., m] += acc * (cs[s] * T.COS_L[m, ck[s]])
    return out


def mdct_granules(sb, block_type):
    """MDCT for a sequence of granules of one channel.

    sb: (G, 18, 32) raw subband samples (granule g).
    block_type: (G,) int array in {0,1,2,3}.
    Returns xr (G, 576) in the reference's memory layout:
    xr[g, band*18 + k]; for short blocks the 18 values per band are
    out[3*m + sblock].
    """
    G = sb.shape[0]
    sbf = sb * _SIGN[None]
    prev = np.concatenate([np.zeros((1, 18, 32)), sbf[:-1]], axis=0)
    mdct_in = np.concatenate([prev, sbf], axis=1)  # (G, 36, 32)
    out = np.zeros((G, 32, 18))

    bt = np.asarray(block_type)
    for b in (1, 3):
        m = bt == b
        if not m.any():
            continue
        fin = mdct_in[m].transpose(0, 2, 1) * T.MDCT_WIN[b][None, None, :]
        # out[m] = sum_k fin[k] cos_l[m][k], ascending k (mdct.c:192-197)
        acc = np.zeros(fin.shape[:2] + (18,))
        for k in range(36):
            acc += fin[:, :, k:k + 1] * T.COS_L[None, None, :, k]
        out[m] = acc
    m = bt == 0
    if m.any():
        # the hand-unrolled long->long transform (mdct.c:199-509) groups
        # terms in a specific association order; replicate it exactly
        fin = mdct_in[m].transpose(0, 2, 1) * T.MDCT_WIN[0][None, None, :]
        out[m] = _mdct_long_unrolled(fin)
    m = bt == 2
    if m.any():
        # three short transforms; input window k+6l+6 (mdct.c:176-184)
        fin = mdct_in[m].transpose(0, 2, 1)  # (g, 32, 36)
        res = np.zeros((fin.shape[0], fin.shape[1], 18))
        for l in range(3):
            seg = fin[:, :, 6 * l + 6: 6 * l + 18] * T.MDCT_WIN[2][None, None, :12]
            acc = np.zeros(fin.shape[:2] + (6,))
            for k in range(12):
                acc += seg[:, :, k:k + 1] * T.COS_S[None, None, :, k]
            res[:, :, l::3] = acc  # out[3m + l]
        out[m] = res

    # aliasing reduction for non-short blocks (mdct.c:83-91)
    longish = bt != 2
    if longish.any():
        o = out[longish]
        for band in range(31):
            for k in range(8):
                bu = o[:, band, 17 - k] * T.ALIAS_CS[k] + o[:, band + 1, k] * T.ALIAS_CA[k]
                bd = o[:, band + 1, k] * T.ALIAS_CS[k] - o[:, band, 17 - k] * T.ALIAS_CA[k]
                o[:, band, 17 - k] = bu
                o[:, band + 1, k] = bd
        out[longish] = o
    return out.reshape(G, 576)
