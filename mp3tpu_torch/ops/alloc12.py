"""Layer I/II bit allocation on the device (K5): the joint-stereo decision
and the greedy allocation of every frame.

The JAX package runs this on the host between its device analysis and its
device quantizers (``mp3tpu/encoder.py:803-813``, with
``mp3tpu/runtime/alloc12.py``).  On a CUDA tensor it is K5
(``csrc/alloc12.cu``, built with ``nvcc`` on first use into
``mp3tpu_torch/build/``): one warp a frame, each greedy step a warp argmin
by shuffles, everything in float64.  On a CPU tensor it runs its plain
version, the JAX package's numpy functions themselves (the port's copy
``runtime/alloc12.py``: ``joint_mode``, then ``greedy_allocation``, all
frames in lockstep).  There is no fallback between the two: a CUDA tensor
never reaches the numpy code, and a build or launch error raises.

``launches`` counts K5's launches.
"""
import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

from ..runtime import alloc12 as host
from ..runtime.profiling import span
from ..tables import layer12 as T
from ..tables import mpeg
from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "alloc12.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "liballoc12.so")
#: no FMA contraction: every float64 operation rounds as numpy's does
NVCC_FLAGS = cuda_build.NVCC_FLAGS + ["-fmad=false"]
#: the keys of ``allocate``'s result that K5 and its plain version share
OUTPUTS = ("ba", "adb_left", "mode", "mode_ext", "jsbound")

#: K5's launches
launches = 0


def build(force=False, extra_flags=()):
    """Compile csrc/alloc12.cu into build/liballoc12.so (if the library
    is missing or older than the source); returns nvcc's output."""
    return cuda_build.build(SOURCE, LIBRARY, NVCC_FLAGS + list(extra_flags),
                            force)


@lru_cache(maxsize=None)
def _library():
    build()
    lib = ctypes.CDLL(LIBRARY)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp3_alloc12.restype = i32
    lib.mp3_alloc12.argtypes = [ptr] * 4 + [i32] * 10 + [ptr] * 7
    return lib


def kernel_tables(layer, table):
    """K5's tables of one (layer, table) as numpy arrays: float64
    snr_after, cost and the bits_for_nonoise ladder (32 x 16 each, from
    ``runtime/alloc12.py``'s ``_snr_ladder`` and ``bits_for_nonoise``) and
    6 * SFS_PER_SCFSI (4); int32 maxba, nbal, the ladder's bound (32 each)
    and the jsbound of mode_ext 0-3 (4)."""
    snr_after, cost, maxba, nbal = host._snr_ladder(layer, table)
    ladder = np.zeros((32, 16))
    if layer == 1:
        ladder[:, :14] = T.SNR_L1[:14][None, :]
        bound = np.full(32, 14)
    else:
        alloc = T.ALLOC[table]
        idx = alloc["quant"] + (np.arange(16)[None, :] > 0)
        ladder = T.SNR_L2[np.minimum(idx, 17)]
        ladder[:, 0] = T.SNR_L2[alloc["quant"][:, 0]]
        bound = maxba - 1
    dtab = np.concatenate([np.asarray(snr_after, np.float64).ravel(),
                           np.asarray(cost, np.float64).ravel(),
                           np.asarray(ladder, np.float64).ravel(),
                           6.0 * T.SFS_PER_SCFSI.astype(np.float64)])
    itab = np.concatenate([maxba, nbal, bound, T.JSB_TABLE[layer - 1]]) \
        .astype(np.int32)
    return dtab, itab


@lru_cache(maxsize=None)
def _device_tables(layer, table, device):
    dtab, itab = kernel_tables(layer, table)
    return (torch.as_tensor(dtab, device=device),
            torch.as_tensor(itab, device=device))


def _check(smr, scfsi, layer):
    F = smr.shape[0]
    dev = smr.device
    cuda_build.check("alloc12", "smr", smr, torch.float64, (F, 2, 32), dev)
    if layer == 2:
        if scfsi is None:
            raise ValueError("alloc12: Layer II needs the scfsi")
        cuda_build.check("alloc12", "scfsi", scfsi, torch.int32, (F, 2, 32),
                         dev)
        return
    if scfsi is not None:
        raise ValueError("alloc12: Layer I takes no scfsi")


def _launch(smr, scfsi, layer, table, nch, sblimit, adb, error_protection,
            joint, mode):
    """K5 on the current stream; returns ``allocate``'s dict of int32
    tensors on smr's device, with "steps" (F,): each frame's greedy
    steps."""
    global launches
    _check(smr, scfsi, layer)
    F = smr.shape[0]
    dev = smr.device
    out = {k: torch.empty((F, 2, 32) if k == "ba" else (F,),
                          dtype=torch.int32, device=dev)
           for k in OUTPUTS + ("steps",)}
    if F:
        dtab, itab = _device_tables(layer, table, dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp3_alloc12(
                smr.data_ptr(), None if scfsi is None else scfsi.data_ptr(),
                dtab.data_ptr(), itab.data_ptr(), F, layer, nch, sblimit,
                int(adb), int(bool(error_protection)), int(bool(joint)),
                int(mode), mpeg.MODE_JOINT, mpeg.MODE_STEREO,
                *(out[k].data_ptr() for k in OUTPUTS + ("steps",)), stream)
        if err != 0:
            raise RuntimeError(f"alloc12: kernel launch failed, CUDA error "
                               f"{err}")
        launches += 1
    return out


def allocate_plain(smr, scfsi, layer, table, nch, sblimit, adb,
                   error_protection, joint, mode):
    """The plain version: ``runtime/alloc12``'s ``joint_mode`` (when
    `joint`) and ``greedy_allocation`` on the host, as
    ``mp3tpu/encoder.py:803-813`` calls them.  Returns the same int32
    tensors as K5 on the CPU, with "steps" None (the lockstep code does
    not count a frame's steps)."""
    _check(smr, scfsi, layer)
    F = smr.shape[0]
    smr_h = smr.detach().cpu().numpy()
    scf_h = (None if scfsi is None
             else scfsi.detach().cpu().numpy().astype(np.int64))
    if joint:
        is_js, mode_ext, jsbound = host.joint_mode(
            smr_h, scf_h, adb, layer, table, nch, error_protection)
        modes = np.where(is_js, mpeg.MODE_JOINT, mpeg.MODE_STEREO)
    else:
        modes = np.full(F, mode)
        mode_ext = np.zeros(F, np.int64)
        jsbound = np.full(F, sblimit if layer == 2 else 32)
    ba, adb_left = host.greedy_allocation(
        smr_h, scf_h, np.full(F, adb), jsbound, layer, table, nch,
        error_protection)
    out = dict(ba=ba, adb_left=adb_left, mode=modes, mode_ext=mode_ext,
               jsbound=jsbound)
    out = {k: torch.as_tensor(np.asarray(v).astype(np.int32))
           for k, v in out.items()}
    out["steps"] = None
    return out


@span("greedy_allocation")
def allocate(smr, scfsi, layer, table, nch, sblimit, adb, error_protection,
             joint, mode):
    """The joint-stereo decision (when `joint`) and the greedy bit
    allocation of F frames: smr (F, 2, 32) float64 (channel 1 a copy of
    channel 0 for mono), scfsi (F, 2, 32) int32 for Layer II, None for
    Layer I; adb the frame's bits; mode the header mode of a frame that is
    not joint.  Returns {"ba": (F, 2, 32), "adb_left", "mode", "mode_ext",
    "jsbound": (F,)} int32 on smr's device and "steps" (K5's greedy steps
    a frame; None on the CPU): one K5 launch on a CUDA tensor, no wait on
    the host; the numpy code on a CPU tensor."""
    args = (smr, scfsi, layer, table, nch, sblimit, adb, error_protection,
            joint, mode)
    if smr.device.type == "cuda":
        return _launch(*args)
    if smr.device.type != "cpu":
        raise ValueError(f"alloc12: unsupported device {smr.device}")
    return allocate_plain(*args)
