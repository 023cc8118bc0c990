"""Bit-reservoir budget scan (port of mp3tpu/ops/jaxresv.py).

The scan is serial over frames with a one-integer carry.  On a CUDA
tensor it is K4 (``csrc/resv_scan.cu``, built with ``nvcc`` on first use
into ``mp3tpu_torch/build/``): ``resv_map_kernel`` maps each chunk of
``chunk_frames`` frames from every level a frame can end at, in
parallel, and ``resv_walk_kernel`` composes the maps and re-walks the
chunks from their starts.  Nothing comes back to the host -- the budgets
and the carried level stay on the device, so the segment program queues
its final encode behind the scan as the JAX package's one program chain
does (``jaxresv.py:6-10``).  On a CPU tensor it runs its plain version,
the native host scan (``runtime.bitstream.resv_scan``, reservoir.c:101-134
policy), which tests/test_jaxresv.py holds equal to the JAX scan; pe
enters it as float64, and K4 widens pe to double as it does.  There is
no fallback between the two: a CUDA tensor never reaches the host scan,
and a build or launch error raises.

``launches`` counts K4's calls (one a wrapper call, two kernels or, for
a single chunk, one) as they run: a call made into a CUDA graph (the
segment program's, ``models/layer3.py``) is counted at each replay of
the graph, not at its capture (``graphs.Captured``).  ``host_scans`` counts the scans that
ran on the host on results the card made, each behind a download: the
multi-rank path's (``parallel/clip.py``), which scans on the host as
the JAX package's does.
"""
import ctypes
import math
import os
from functools import lru_cache

import numpy as np
import torch

from ..runtime.bitstream import resv_scan
from ..runtime.profiling import span
from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "resv_scan.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libresv_scan.so")
#: no FMA contraction: trunc(pe*3.1 - mean) rounds twice, as on the host
NVCC_FLAGS = cuda_build.NVCC_FLAGS + ["-fmad=false"]
#: the granules of a frame K4 takes at most (csrc/resv_scan.cu kTile)
MAX_GRANULES_A_FRAME = 2048
#: SMs of an H100, which the map build's blocks should fill
SMS = 132
#: a map's states at most, and a clip's chunks at most: one thread each
#: (kMaxStates, kMaxChunks)
MAX_STATES = MAX_CHUNKS = 1024
#: the shared memory the walk block keeps a clip's maps in (kMapSmem)
MAP_SMEM_BYTES = 196608

#: K4's launches
launches = 0
#: host scans of the card's results (each waits for a download)
host_scans = 0


def build(force=False, extra_flags=()):
    """Compile csrc/resv_scan.cu into build/libresv_scan.so (if the
    library is missing or older than the source); returns nvcc's
    output."""
    return cuda_build.build(SOURCE, LIBRARY, NVCC_FLAGS + list(extra_flags),
                            force)


@lru_cache(maxsize=None)
def _library():
    build()
    lib = ctypes.CDLL(LIBRARY)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp3_resv_scan.restype = i32
    lib.mp3_resv_scan.argtypes = [ptr, ptr, ptr, i32, ptr] + [i32] * 9 + \
        [ptr] * 4
    return lib


def states(resv_max):
    """The states of a chunk's map: the levels 8*s in [0, resv_max] a
    frame can end at, and one for "still size0"."""
    return max(resv_max, 0) // 8 + 2


def map_words(F, chunk, resv_max):
    """uint16 map entries a clip: (K - 1) maps (the last chunk needs
    none), rounded up to 16 bytes."""
    K = max(1, -(-F // chunk))
    return -(-(K - 1) * states(resv_max) // 8) * 8


def state_groups(B, F, chunk, resv_max):
    """The blocks among which the map build splits a chunk's states: as
    few as fill the SMs with B*(K-1) chunks' blocks, each at least a
    warp."""
    maps = B * (max(1, -(-F // chunk)) - 1)
    if not maps:
        return 1
    return max(1, min(-(-SMS // maps), -(-states(resv_max) // 32)))


def chunk_frames(B, F, R, resv_max):
    """K4's chunk, in frames, for B clips of F frames of R granules.

    The walks are C*R granules long, the composition K = ceil(F/C)
    dependent lookups; C ~ sqrt(F/(3R)) balances the two on one clip,
    and a batch of clips, whose map build is bound by its operations
    (state_groups spreads it over the SMs), takes sqrt(B) times fewer
    lookups (phase 3d of chip_smoke.py times K4 at other chunks).  K is
    held to what the walk block's shared memory and threads take; one
    chunk (the walk alone) where a map would need more than MAX_STATES
    states."""
    S1 = states(resv_max)
    if F <= 1 or S1 > MAX_STATES:
        return max(F, 1)
    k_max = min(MAX_CHUNKS, 1 + MAP_SMEM_BYTES // 2 // S1)
    C = max(1, math.ceil(math.sqrt(F / (3 * R) * math.sqrt(B))),
            -(-F // k_max))
    return min(C, F)


def granule_major(x, nch, mode_gr):
    """(nch, G) -> (F, R) with r = gr*nch + ch (the scan's order)."""
    G = x.shape[1]
    F = G // mode_gr
    return x.reshape(nch, F, mode_gr).permute(1, 2, 0) \
        .reshape(F, mode_gr * nch)


def from_granule_major(x, nch, mode_gr):
    """(F, R) -> (nch, G)."""
    F = x.shape[0]
    return x.reshape(F, mode_gr, nch).permute(2, 0, 1) \
        .reshape(nch, F * mode_gr)


def _native(pe, demand, size, mean_bits, resv_max, mode_gr, nch, delta):
    """Native scan over granule-major numpy frames; returns
    (budgets (F, R) int64, size_out)."""
    F = pe.shape[0]
    to_ch = lambda a: a.reshape(F, mode_gr, nch).transpose(2, 0, 1) \
        .reshape(nch, F * mode_gr)  # noqa: E731
    bud, size = resv_scan(to_ch(pe), to_ch(demand), None, None, F, nch,
                          mean_bits, resv_max, mode_gr, delta=delta,
                          size=size)
    return bud.reshape(nch, F, mode_gr).transpose(1, 2, 0) \
        .reshape(F, mode_gr * nch), size


def _plain(pe, demand, size, ok, mean_bits, resv_max, mode_gr, nch, delta):
    """One clip's scan on the host: pe (F, R) float64, demand (F, R)
    int64 numpy, ok (F,) bool; returns (budgets (F, R) int64, size_out).
    A padded frame is scanned from the carried level, which it then
    leaves untouched."""
    F = pe.shape[0]
    budgets = np.zeros((F, mode_gr * nch), np.int64)
    f = 0
    while f < F:
        if ok[f]:
            e = f
            while e < F and ok[e]:
                e += 1
            budgets[f:e], size = _native(pe[f:e], demand[f:e], size,
                                         mean_bits, resv_max, mode_gr, nch,
                                         delta)
        else:
            e = f + 1
            budgets[f:e], _ = _native(pe[f:e], demand[f:e], size, mean_bits,
                                      resv_max, mode_gr, nch, delta)
        f = e
    return budgets, size


def _check_k4(pe, demand, valid, size0, mode_gr, nch):
    B, F, R = pe.shape
    dev = pe.device
    if R != mode_gr * nch or R > MAX_GRANULES_A_FRAME:
        raise ValueError(f"resv_scan: {R} granules a frame for mode_gr "
                         f"{mode_gr}, nch {nch}")
    for name, t, dtype, shape in (("pe", pe, torch.float32, (B, F, R)),
                                  ("demand", demand, torch.int32, (B, F, R)),
                                  ("size0", size0, torch.int32, (B,))):
        cuda_build.check("resv_scan", name, t, dtype, shape, dev)
    if valid is not None:
        shape = (F,) if valid.dim() == 1 else (B, F)
        cuda_build.check("resv_scan", "valid", valid, torch.bool, shape, dev)


def _launch(pe, demand, valid, size0, mean_bits, resv_max, mode_gr, nch,
            delta, _chunk=None):
    """K4 over B clips on the current stream: pe (B, F, R) float32,
    demand (B, F, R) int32, valid None, (F,) or (B, F) bool, size0 (B,)
    int32, all on one CUDA device.  Returns (budgets (B, F, R) int32,
    size_out (B,) int32) on it.  The maps' workspace comes from the
    caching allocator on the same stream.  `_chunk` forces the chunk
    (tests and measurements; every chunk gives the same result)."""
    global launches
    _check_k4(pe, demand, valid, size0, mode_gr, nch)
    B, F, R = pe.shape
    dev = pe.device
    budgets = torch.empty((B, F, R), dtype=torch.int32, device=dev)
    size_out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        stride = 0 if valid is None or valid.dim() == 1 else F
        chunk = _chunk or chunk_frames(B, F, R, resv_max)
        maps = torch.empty(B * map_words(F, chunk, resv_max),
                           dtype=torch.int16, device=dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp3_resv_scan(
                pe.data_ptr(), demand.data_ptr(),
                None if valid is None else valid.data_ptr(), stride,
                size0.data_ptr(), B, F, nch, mode_gr, int(mean_bits),
                int(resv_max), int(delta), int(chunk),
                state_groups(B, F, chunk, resv_max), maps.data_ptr(),
                budgets.data_ptr(), size_out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"resv_scan: kernel launch failed, CUDA "
                               f"error {err}")
        launches += 1
    return budgets, size_out


def _level(size, dev, B=None):
    """A carried level (int, numpy value or tensor) as int32 on `dev`:
    () or, with B, (B,).  A Python value is filled in on the device, not
    uploaded (an upload from pageable memory would wait for the
    stream)."""
    shape = () if B is None else (B,)
    if isinstance(size, torch.Tensor):
        return size.to(dev, torch.int32).reshape(shape)
    if np.ndim(size):
        return torch.as_tensor(np.asarray(size), dtype=torch.int32,
                               device=dev).reshape(shape)
    return torch.full(shape, int(size), dtype=torch.int32, device=dev)


@span("scan_budgets")
def scan_budgets(pe, demand, size0, mean_bits, resv_max, mode_gr, nch,
                 delta, valid=None):
    """pe, demand: (F, R) granule-major float32/int tensors; size0: the
    carried reservoir level (int, numpy value or 0-d tensor); valid:
    optional (F,) bool -- False frames are bucket padding and leave the
    level as it was.  Returns (budgets (F, R) int32, size_out () int32),
    both on pe's device: on a CUDA tensor from one K4 launch, with no
    wait on the host; on a CPU tensor from the native scan."""
    dev = pe.device
    if dev.type == "cuda":
        bud, size = _launch(pe.contiguous()[None],
                            demand.to(torch.int32).contiguous()[None],
                            None if valid is None else valid.to(torch.bool),
                            _level(size0, dev, 1), mean_bits, resv_max,
                            mode_gr, nch, delta)
        return bud[0], size[0]
    if dev.type != "cpu":
        raise ValueError(f"scan_budgets: unsupported device {dev}")
    pe_h = pe.detach().to(torch.float64).numpy()
    dm_h = demand.detach().to(torch.int64).numpy()
    F = pe_h.shape[0]
    ok = (np.ones(F, bool) if valid is None
          else valid.detach().numpy().astype(bool))
    budgets, size = _plain(pe_h, dm_h, int(size0), ok, mean_bits, resv_max,
                           mode_gr, nch, delta)
    return (torch.as_tensor(budgets, dtype=torch.int32),
            torch.tensor(size, dtype=torch.int32))


def scan_budgets_batched(pe, demand, size0, mean_bits, resv_max, mode_gr,
                         nch, delta):
    """Clip-batched scan of the corpus path: pe, demand (B, F, R)
    granule-major tensors, size0 (B,) carried levels.  Returns (budgets
    (B, F, R) int32, size_out (B,) int32), both on pe's device: one K4
    launch for the B clips on a CUDA tensor, B native scans on a CPU
    tensor."""
    dev = pe.device
    B = pe.shape[0]
    if dev.type == "cuda":
        return _launch(pe.contiguous(), demand.to(torch.int32).contiguous(),
                       None,
                       _level(size0, dev, B), mean_bits, resv_max, mode_gr,
                       nch, delta)
    if dev.type != "cpu":
        raise ValueError(f"scan_budgets_batched: unsupported device {dev}")
    pe_h = pe.detach().to(torch.float64).numpy()
    dm_h = demand.detach().to(torch.int64).numpy()
    s0 = torch.as_tensor(size0).to(torch.int64).numpy()
    budgets = np.zeros(pe_h.shape, np.int64)
    sizes = np.zeros(B, np.int64)
    ok = np.ones(pe_h.shape[1], bool)
    for b in range(B):
        budgets[b], sizes[b] = _plain(pe_h[b], dm_h[b], int(s0[b]), ok,
                                      mean_bits, resv_max, mode_gr, nch,
                                      delta)
    return (torch.as_tensor(budgets, dtype=torch.int32),
            torch.as_tensor(sizes, dtype=torch.int32))

