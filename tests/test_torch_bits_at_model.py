"""A lane-level numpy model of csrc/bits_at.cu against bits_at_plain.

The CUDA kernel cannot run on the CPU.  This model follows its lanes
step by step -- float4 i = 32k + lane holds lines 4i..4i+3, warp
reductions are max/sum over the 32 lanes, subdivide reads the sfb table
by lane, each pair adds its region's candidate tables from the LUT with
a zero row for unused candidates, three regions' sums share one word
10 bits apiece, and count1 takes the next float4's nibble through a
shuffle with the wrap from the last float4 to the first -- so that the
kernel's index arithmetic and table logic are checked here, and a change
to the kernel's algorithm can be tried here first.  The kernel itself is
held to bits_at_plain on the card (tests/test_torch_bits_at_card.py).
"""
import numpy as np
import pytest
import torch

from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop
from mp3tpu_torch.tables import mpeg
from test_torch_bits_at_card import kernel_args, random_batch

torch.set_num_threads(1)

VECS, ROUNDS, LAST_LANE, ZERO_ROW, N_ESC = 144, 5, 15, 32, 8193
LANES = np.arange(32)


def _quantize(x, step):
    """Each operation rounded to float32, as the kernel's __f*_rn."""
    v = np.float32(np.float32(np.float32(x * step) - np.float32(0.0946))
                   + np.float32(0.5))
    v = np.minimum(np.maximum(np.floor(v), np.float32(0)),
                   np.float32(2147483520.0))
    return v.astype(np.int64)


def _candidates(mx, first, esc_a, esc_b):
    if mx == 0:
        return (ZERO_ROW, ZERO_ROW, ZERO_ROW)
    if mx >= 15:
        e = min(mx - 15, N_ESC - 1)
        return (esc_a[e], esc_b[e], ZERO_ROW)
    f = first[mx]
    return {2: (2, 3, ZERO_ROW), 5: (5, 6, ZERO_ROW), 7: (7, 8, 9),
            10: (10, 11, 12), 13: (13, 15, ZERO_ROW)}.get(
                f, (f, ZERO_ROW, ZERO_ROW))


def _choose(mx, c, s):
    if mx == 0:
        return 0, 0
    if mx >= 15:
        return (c[1] if s[1] < s[0] else c[0]), min(s[0], s[1])
    table, bits = c[0], s[0]
    for j in (1, 2):
        if c[j] != ZERO_ROW and s[j] <= bits:
            table, bits = c[j], s[j]
    return table, bits


def model_granule(xr75, step, shrt, sblk, rate, lut, hlen, r0_pairs):
    """One warp's granule, as csrc/bits_at.cu computes it."""
    sfb, subdv, first = rate[0:23], rate[23:69], rate[69:84]
    esc_a, esc_b = rate[84:84 + N_ESC], rate[84 + N_ESC:]
    ix = np.zeros((ROUNDS, 32, 4), np.int64)
    for k in range(ROUNDS):
        for lane in range(32):
            i = 32 * k + lane
            if i < VECS:
                ix[k, lane] = _quantize(xr75[4 * i:4 * i + 4], step)
    p_nz = np.full(32, -1)
    p_big = np.full(32, -1)
    imax = np.zeros(32, np.int64)
    for k in range(ROUNDS):
        for h in range(2):
            x, y = ix[k, :, 2 * h], ix[k, :, 2 * h + 1]
            p = 2 * (32 * k + LANES) + h
            p_nz = np.where((x | y) != 0, p, p_nz)
            p_big = np.where(np.maximum(x, y) > 1, p, p_big)
            imax = np.maximum(imax, np.maximum(x, y))
    ix_max = int(imax.max())
    count1 = int(p_nz.max() - p_big.max()) >> 1
    big_values = int(p_nz.max()) + 1 - 2 * count1
    if shrt:
        count1, big_values = 0, 288
    bvr = 2 * big_values
    anz = min(sum(1 for lane in range(23) if sfb[lane] < bvr), 22)
    r0i, r1i = subdv[2 * anz], subdv[2 * anz + 1]
    r0 = max(lane if lane < 22 and lane <= r0i and sfb[lane + 1] <= bvr
             else 0 for lane in range(32))
    r1 = max(lane if lane < 22 and lane <= r1i
             and sfb[min(r0 + lane + 2, 22)] <= bvr else 0
             for lane in range(32))
    a1 = min(sfb[min(r0 + 1, 22)], bvr)
    a2 = min(max(sfb[min(r0 + r1 + 2, 22)], a1), bvr)
    if sblk and not shrt:
        r0, r1, a1, a2 = 7, 13, min(sfb[8], bvr), bvr
    if shrt:
        r0, r1 = 8, 36
    if big_values == 0:
        r0 = r1 = a1 = a2 = 0

    def region(p):
        if shrt:
            return 0 if p < r0_pairs else 1
        if 2 * p >= bvr:
            return 3
        return 0 if 2 * p < a1 else (1 if 2 * p < a2 else 2)

    mx = [0, 0, 0]
    for k in range(ROUNDS):
        for lane in range(32):
            for h in range(2):
                r = region(2 * (32 * k + lane) + h)
                if r < 3:
                    pm = max(ix[k, lane, 2 * h], ix[k, lane, 2 * h + 1])
                    mx[r] = max(mx[r], int(pm))
    cands = [_candidates(m, first, esc_a, esc_b) for m in mx]
    acc = np.zeros((3, 32), np.int64)          # candidate j, lane
    for k in range(ROUNDS):
        for lane in range(32):
            i = 32 * k + lane
            for h in range(2):
                r = region(2 * i + h)
                if i < VECS and r < 3:
                    cls = (min(ix[k, lane, 2 * h], 15) * 16
                           + min(ix[k, lane, 2 * h + 1], 15))
                    for j in range(3):
                        acc[j, lane] += int(lut[cands[r][j], cls]) << (10 * r)
    assert acc.max() < 1 << 30
    chosen = [_choose(mx[r], cands[r],
                      [int(((acc[j] >> (10 * r)) & 1023).sum())
                       for j in range(3)]) for r in range(3)]
    if shrt:
        chosen[2] = (0, 0)

    start = 2 * big_values
    mis = (start & 3) != 0
    lo = start - 2 if mis else start
    hi = lo + 4 * count1
    nib = ((np.minimum(ix[..., 0], 1) << 3) | (np.minimum(ix[..., 1], 1) << 2)
           | (np.minimum(ix[..., 2], 1) << 1) | np.minimum(ix[..., 3], 1))
    b0raw = signs = 0
    for k in range(ROUNDS):
        here = nib[k, (LANES + 1) & 31]
        wrap = nib[k + 1 if k + 1 < ROUNDS else 0, 0]
        nxt = np.where(LANES == (31 if k + 1 < ROUNDS else LAST_LANE),
                       wrap, here)
        for lane in range(32):
            i = 32 * k + lane
            if i < VECS and lo <= 4 * i < hi:
                p16 = (((nib[k, lane] & 3) << 2) | (nxt[lane] >> 2) if mis
                       else nib[k, lane])
                b0raw += int(hlen[p16])
                signs += bin(int(p16)).count("1")
    b0 = b0raw + signs
    b1 = 4 * count1 + signs
    c1_sel = 0 if b0 < b1 else 1
    total = sum(b for _, b in chosen) + (b0 if c1_sel == 0 else b1)
    bits = np.float32(total) if ix_max <= loop.IXMAX else np.float32(1e9)
    return dict(bits=float(bits), count1=count1, big_values=big_values,
                r0=r0, r1=r1, a1=a1, a2=a2,
                table_select=[int(t) for t, _ in chosen],
                count1table_select=c1_sel, ix_max=ix_max)


@pytest.mark.parametrize("seed,version", [(1, mpeg.MPEG1),
                                          (2, mpeg.MPEG2_LSF)])
def test_lane_model_equals_plain_chain(seed, version):
    G = 300
    args = kernel_args(*random_batch(seed, G), "cpu", version)
    xr75p, qss, short, sblk, ST = args
    want = K.bits_at_plain(*args)
    rate = K.rate_tables(loop.static_tables(version, 0)["sfb_l"])
    assert np.array_equal(rate, ST["bits_at_tab"].numpy())
    lut = np.vstack([K.PAIR_BITS.astype(np.int64),
                     np.zeros((1, 256), np.int64)])
    steps = torch.exp2(-0.1875 * qss).numpy()
    over = 0
    for g in range(G):
        got = model_granule(xr75p[g].numpy(), steps[g], bool(short[g]),
                            bool(sblk[g]), rate, lut, K.C1_HLEN_A,
                            ST["r0_pairs_short"])
        ref = {k: v[g].tolist() for k, v in want.items()}
        assert got == ref, g
        over += ref["bits"] == 1e9
    assert 0 < over < G
