"""Layer I/II bit allocation on the device (K5): the joint-stereo decision
and the greedy allocation of every frame.

The JAX package runs this on the host between its device analysis and its
device quantizers (``mp3tpu/encoder.py:803-813``, with
``mp3tpu/runtime/alloc12.py``).  On a CUDA tensor it is K5
(``csrc/alloc12.cu``, built with ``nvcc`` on first use into
``mp3tpu_torch/build/``): one warp a frame, each greedy step's argmin as
ordered uint64 keys reduced with ``redux.sync``, the frame's state in
registers, the fit in integers.  On a CPU tensor it runs its plain
version, the JAX package's numpy
functions themselves (the port's copy ``runtime/alloc12.py``:
``joint_mode``, then ``greedy_allocation``, all frames in lockstep).
There is no fallback between the two: a CUDA tensor never reaches the
numpy code, and a build or launch error raises.

``launches`` counts K5's launches.
"""
import ctypes
import os
import re
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
    lib.mp3_alloc12_occupancy.restype = i32
    lib.mp3_alloc12_occupancy.argtypes = [i32, ptr]
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
    _check_integer_design(dtab, itab)
    return dtab, itab


def _check_integer_design(dtab, itab):
    """What K5's integer design rests on (csrc/alloc12.cu): every cost and
    6 * SFS_PER_SCFSI is an integer, so the fit and bits_for_nonoise are
    exact in int32 when the largest running sum fits it (every candidate
    of a frame at its top allocation with both channels' first-step bits);
    maxba <= 15, so a step's SNR index ba + 1 stays in its row; no SNR
    after a step is NaN or carries a sign, so -smr + snr_after is never a
    -0.0 and the step's key is the sign-flip map alone."""
    snr_after, cost, sfs6 = dtab[:512], dtab[512:1024], dtab[1536:1540]
    if not ((cost == np.round(cost)).all()
            and (sfs6 == np.round(sfs6)).all()):
        raise AssertionError("alloc12: a cost or 6 * SFS_PER_SCFSI is not "
                             "an integer")
    first = 4 + 2 * sfs6.max()
    largest = 64 * (np.abs(cost).max() + first)
    if not largest < 2 ** 31:
        raise AssertionError(f"alloc12: a running sum of {largest} bits "
                             f"does not fit int32")
    if not (itab[:32] <= 15).all():
        raise AssertionError("alloc12: a maxba above 15")
    if not (np.isfinite(snr_after).all() and not np.signbit(snr_after)
            .any()):
        raise AssertionError("alloc12: an SNR after a step is NaN or "
                             "signed")


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


def occupancy(layer):
    """(blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPer-
    Multiprocessor), warps (frames) a block) of K5 at `layer`."""
    per_block = ctypes.c_int(0)
    n = _library().mp3_alloc12_occupancy(int(layer),
                                         ctypes.byref(per_block))
    if n <= 0:
        raise RuntimeError(f"alloc12: occupancy query failed ({n})")
    return n, per_block.value


def waves(F, layer, device=None):
    """The waves in which one launch runs F frames on `device`'s SMs."""
    sms = torch.cuda.get_device_properties(
        device or torch.cuda.current_device()).multi_processor_count
    per_sm, per_block = occupancy(layer)
    return -(-(-(-F // per_block)) // (per_sm * sms))


def kernel_report(log):
    """{"alloc12_kernel<1>", "alloc12_kernel<2>": {"registers", "stack",
    "spill_stores", "spill_loads"}} from nvcc's ``-Xptxas -v`` output for
    csrc/alloc12.cu."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if "alloc12_kernelILi1E" in name:
            key = "alloc12_kernel<1>"
        elif "alloc12_kernelILi2E" in name:
            key = "alloc12_kernel<2>"
        else:
            continue
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        if not (props and regs):
            raise ValueError(f"alloc12: no properties for {name} in the "
                             f"ptxas report")
        out[key] = dict(registers=int(regs.group(1)),
                        stack=int(props.group(1)),
                        spill_stores=int(props.group(2)),
                        spill_loads=int(props.group(3)))
    return out


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
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _library().mp3_alloc12(
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
