"""Published rates of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet at the 700 W power limit, frozen for the benchmark: a copy of
``HBM_BYTES_PER_S`` of ``mp3tpu_torch/tools/__init__.py`` (commit
8dfe798).  The float32 and int32 rates join it with the first metric
that reads them."""

#: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
