"""NumPy float64 reference implementation ("oracle").

This package is the correctness anchor of the TPU framework: a direct,
batched-but-order-faithful implementation of the ISO encoder algorithms
used (a) by the test-suite to golden-check every device kernel, and
(b) as the exact sequential mode for bit-level parity experiments
against the compiled reference binary.

It is deliberately *not* the production path -- the production path is
the JAX/XLA pipeline in ``mp3tpu.models`` / ``mp3tpu.ops`` plus the C++
bitstream assembler in ``native/``.
"""
from .encoder import encode_layer3  # noqa: F401
