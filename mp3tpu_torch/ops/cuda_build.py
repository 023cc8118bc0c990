"""Build a CUDA source of ``csrc/`` into a plain-C shared library.

Each kernel is compiled with ``nvcc`` for ``sm_90a`` on first use into
``mp3tpu_torch/build/`` (git-ignored) and loaded with ``ctypes``;
importing a kernel module needs no toolkit.
"""
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin)")


def build(source, library, flags, force=False):
    """Compile `source` into `library` with `flags` if the library is
    missing or older than the source (or `force`).  The library is
    written under a temporary name and renamed.  Returns the compiler's
    output (stdout + stderr; empty when nothing was built)."""
    if (not force and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return ""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc(), *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    name = os.path.basename(source)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr


def check(kernel, name, t, dtype, shape, device):
    """Raise unless tensor `t` is on `device`, of `dtype` and `shape`, and
    contiguous: what a kernel's wrapper checks before it launches."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
