"""mp3tpu_torch: the single-device encoder of ``mp3tpu`` ported to PyTorch
(Layer III one-shot and streaming, MPEG-1 and MPEG-2 LSF; Layers I/II;
``python -m mp3tpu_torch``).

The JAX package ``mp3tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``encoder.py``, ``cli.py``) and shares its
jax-free parts as they are: ``mp3tpu.tables``, ``mp3tpu.config``,
``mp3tpu.cli``, ``mp3tpu.numpy_ref``, ``mp3tpu.decoder``,
``mp3tpu.runtime.{wav,aiff,bitstream,alloc12,profiling,mpg123}`` and the
native assembler under ``native/``.  Nothing here imports jax.

Every entry point takes an explicit ``device``; there is no automatic
pick.  On a CUDA device the rate loop's bit-count histogram runs in a
hand-written CUDA kernel (``csrc/hist_c1.cu``); on the CPU it runs the
kernel's plain PyTorch version.

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
