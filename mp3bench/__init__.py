"""The benchmark of ``mp3tpu_torch``, the PyTorch and CUDA port: one
process runs one cell once (``run.py``).  Cells, configurations,
traffic mixes and per-layer metrics are found by name from
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<mix>.json``,
``entries/<entry>.py`` and ``metrics/<metric>.py``.  Nothing here
imports ``jax`` or the JAX package ``mp3tpu``."""
