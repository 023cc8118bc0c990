"""Derived DSP tables: polyphase filterbank matrix, MDCT bases, windows.

Formulas match the ISO reference encoder:
  - analysis filter matrix: encode.c:331-345 (cos((2i+1)(16-k)pi/64),
    rounded to 1e-9 like the ISO document tables)
  - 512-tap analysis window: tables.c:1149 (shipped data)
  - MDCT windows and cosine bases: mdct.c:129-171
  - aliasing-reduction butterflies (Table B.9): mdct.c:18-46
  - quantizer boundary table: pow_nint.c:13-20
"""
import math
import os

import numpy as np

from .mpeg import REF_PI

_D = np.load(os.path.join(os.path.dirname(__file__), "data", "iso_tables.npz"))

ENWINDOW = _D["enwindow"]  # 512-tap analysis window
ABSTHR = {0: _D["absthr_0"], 1: _D["absthr_1"], 2: _D["absthr_2"]}


def _ana_filter():
    """32x64 polyphase analysis matrix, rounded to 9 decimals."""
    i = np.arange(32)[:, None]
    k = np.arange(64)[None, :]
    m = 1e9 * np.cos((2 * i + 1) * (16 - k) * REF_PI / 64.0)
    # round-half-away-from-zero, like modf(x +/- 0.5) in encode.c:338-341
    m = np.where(m >= 0, np.floor(m + 0.5), np.ceil(m - 0.5))
    return m * 1e-9


ANA_FILTER = _ana_filter()  # (32, 64)


def _mdct_windows():
    w = np.zeros((4, 36))
    i = np.arange(36)
    w[0] = np.sin(REF_PI / 36 * (i + 0.5))                      # long
    w[1][:18] = np.sin(REF_PI / 36 * (i[:18] + 0.5))            # start
    w[1][18:24] = 1.0
    w[1][24:30] = np.sin(REF_PI / 12 * (i[24:30] + 0.5 - 18))
    w[1][30:36] = 0.0
    w[2][:12] = np.sin(REF_PI / 12 * (i[:12] + 0.5))            # short
    w[3][:6] = 0.0                                              # stop
    w[3][6:12] = np.sin(REF_PI / 12 * (i[6:12] + 0.5 - 6))
    w[3][12:18] = 1.0
    w[3][18:] = np.sin(REF_PI / 36 * (i[18:] + 0.5))
    return w


MDCT_WIN = _mdct_windows()  # (4, 36)


def _cos_basis(N):
    m = np.arange(N // 2)[:, None]
    k = np.arange(N)[None, :]
    return np.cos((REF_PI / (2 * N)) * (2 * k + 1 + N // 2) * (2 * m + 1)) / (N / 4)


COS_L = _cos_basis(36)  # (18, 36)
COS_S = _cos_basis(12)  # (6, 12)

# Aliasing-reduction butterflies, Table B.9 (mdct.c:23,38-44)
_c = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
_sq = np.sqrt(1.0 + _c * _c)
ALIAS_CA = _c / _sq
ALIAS_CS = 1.0 / _sq

# Quantizer decision boundaries: ix = #{i in [1,2047] : x >= (i-0.4054)^(4/3)}.
# This reproduces pow_nint() including its hidden cap at 2047
# (pow_nint.h:15-49: the gallop/binary search never returns more).
# Computed with libm pow (math.pow) for bit-identity with the C tables;
# numpy's vectorized power can differ by 1 ulp.
POW_NINT_BOUND = np.array([math.pow(i - 0.4054, 4.0 / 3.0)
                           for i in range(1, 2048)])
IX_MAX_QUANT = 2047

# |ix|^(4/3) lookup used by calc_noise (loop.c:1003-1021)
POW_4_3 = np.array([math.pow(float(i), 4.0 / 3.0) for i in range(2048)])
