"""mp3tpu_torch: the single-device encoder of ``mp3tpu`` ported to PyTorch
(Layer III one-shot and streaming, MPEG-1 and MPEG-2 LSF; Layers I/II;
``python -m mp3tpu_torch``).

The JAX package ``mp3tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``encoder.py``, ``cli.py``) and imports
nothing of it.  What it needs of the JAX package's jax-free parts it
keeps as copies: ``tables`` (with ``tables/data/*.npz``), ``config``,
``numpy_ref``, ``decoder``, ``runtime`` (bitstream binding, alloc12,
wav, aiff, profiling), the CLI's parser and readers, and the native
assembler's source (``csrc/mp3bits.cpp``, ``csrc/huffdata.h``), built
with g++ at first use.  Nothing here imports jax.

Every entry point takes an explicit ``device``; there is no automatic
pick.  On a CUDA device each bit evaluation of the rate loop runs in
one hand-written CUDA kernel (``csrc/bits_at.cu``); on the CPU it runs
the kernel's plain PyTorch version.

Importing the package turns TF32 off: the filterbank, MDCT and psy
matmuls feed a 16-bit quantizer and threshold decisions and need true
float32, and the exact-integer bit-count contraction of the plain
histogram relies on float32 products being exact.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda():
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mp3tpu_torch: device='cuda' was requested but torch reports no "
            "usable CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the plain PyTorch path")


def resolve_device(device):
    """torch.device for an explicit device argument; CUDA must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev
