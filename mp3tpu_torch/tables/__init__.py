"""Constant tables for the TPU-native MPEG audio encoder.

Numeric data (Huffman codes, psy-model partitions, analysis window,
absolute thresholds, Layer II allocation tables) is normative ISO
11172-3 / 13818-3 data, shipped in ``data/*.npz`` (see
``tools/extract_tables.py`` for provenance).  Derived tables (filterbank
matrix, MDCT bases, spreading functions) are computed here with the same
formulas the ISO reference encoder uses (citations given per function).
"""
from .mpeg import *  # noqa: F401,F403
from .dsp import *  # noqa: F401,F403
from .psy import psy_params_for_sfreq  # noqa: F401
from .huffman import HUFF  # noqa: F401
