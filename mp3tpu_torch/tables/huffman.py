"""Layer III Huffman code tables (ISO 11172-3 Table B.7) as dense arrays.

Loaded from ``data/huffman.npz`` (see tools/extract_tables.py).  Parity
reference: huffman.c:11-118.  Exposes, besides the raw codes/lengths,
fused lookup tables used by the vectorized bit counting:

  PAIR_BITS[t, x16*16+y16]: bits to code a clipped pair (x16,y16) with
  table t, *including* sign bits and (for ESC tables) one linbits field
  per clipped component -- i.e. exactly what count_bit (loop.c:172-225)
  adds per pair when the true values exceed 14.
"""
import os
from dataclasses import dataclass

import numpy as np

_H = np.load(os.path.join(os.path.dirname(__file__), "data", "huffman.npz"))


@dataclass(frozen=True)
class HuffTables:
    codes: np.ndarray   # (34, 16, 16) uint32
    hlen: np.ndarray    # (34, 16, 16) uint8
    xlen: np.ndarray    # (34,)
    ylen: np.ndarray    # (34,)
    linbits: np.ndarray  # (34,)
    linmax: np.ndarray  # (34,)
    pair_bits: np.ndarray  # (32, 256) int32 fused per-pair bit cost

    def count1_hlen(self, which):
        """hlen for quad table 32/33.

        Production callers index conformantly, p = 8v+4w+2x+y (first
        sample at the MOST significant bit, ISO 11172-3); only the
        byte-exact oracle keeps dist10's reversed p = v+2w+4x+8y
        (l3bitstream.c:740, the inherited conformance bug -- see
        tests/test_conformance.py).  The table itself is
        order-agnostic: quad A is 4 bits flat, quad B's hlen is
        palindromic under bit reversal."""
        return self.hlen[32 + which, 0, :16]


def _build():
    codes = _H["codes"]
    hlen = _H["hlen"]
    meta = _H["meta"]
    xlen, ylen, linbits, linmax = meta.T

    pair = np.zeros((32, 256), dtype=np.int32)
    x = np.arange(16)[:, None]
    y = np.arange(16)[None, :]
    for t in range(32):
        if xlen[t] == 0:
            continue
        bits = hlen[t].astype(np.int32)
        bits = bits + (x != 0) + (y != 0)  # sign bits
        if t > 15:
            # one linbits field whenever the clipped component is 15,
            # matching count_bit's x>14 / y>14 test on the *unclipped*
            # value: a clipped 15 always implies the original was >14
            # except when the original was exactly 15... it was >14 then
            # too, so clip-to-15 <=> original>14 holds for all inputs
            # >14; original==15 pays linbits as well (loop.c:193-201).
            bits = bits + (x == 15) * linbits[t] + (y == 15) * linbits[t]
        pair[t] = bits.reshape(-1)
    return HuffTables(codes=codes, hlen=hlen, xlen=xlen, ylen=ylen,
                      linbits=linbits, linmax=linmax, pair_bits=pair)


HUFF = _build()

# Candidate table-choice structure from new_choose_table (loop.c:1793-1899):
# for max<15 the reference takes the first table whose xlen > max from
# {1,2,3,5,6,7,8,9,10,11,12,13,15} and then compares specific pairs.
# first_candidate[max] = that first table index.
def _first_tab():
    ft = np.zeros(15, dtype=np.int32)
    for m in range(15):
        if m == 0:
            ft[m] = 0  # unused (max==0 returns table 0)
            continue
        for i in range(14):
            if HUFF.xlen[i] > m:
                ft[m] = i
                break
    return ft


FIRST_TABLE_FOR_MAX = _first_tab()

# ESC table choice: first of 15..23 then 24..31 with linmax >= max-15.
# Note the first scan really starts at table 15 (loop.c:1875): for
# max==15 the non-ESC 16x16 table 15 (linmax 0) is selected.
def _esc_tab():
    a = np.zeros(8192 + 1, dtype=np.int32)
    b = np.zeros(8192 + 1, dtype=np.int32)
    for m in range(8193):
        for i in range(15, 24):
            if HUFF.linmax[i] >= m:
                a[m] = i
                break
        for i in range(24, 32):
            if HUFF.linmax[i] >= m:
                b[m] = i
                break
    return a, b


ESC_TABLE_A, ESC_TABLE_B = _esc_tab()
