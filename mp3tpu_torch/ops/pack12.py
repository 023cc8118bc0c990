"""Layer I/II frame packing with the CRC on the device (K6).

The JAX package packs the flat (value, length) element stream of its
host marshalling (``mp3tpu/encoder.py:904``) with the native packer
(``runtime/bitstream.pack_elements``, MSB-first), each frame's CRC-16
computed before in a Python loop over frames
(``numpy_ref/layer12._crc_calc``, ``mp3tpu/encoder.py:904``).  Frames on
the CBR grid are all ``frame_bytes`` long, so each packs into its own byte
range.  On a CUDA tensor this is K6 (``csrc/pack12.cu``, built with
``nvcc`` on first use into ``mp3tpu_torch/build/``): one block a frame, a
scan of the lengths, the bits ORed into a shared-memory copy of the frame,
and the CRC by one thread.  On a CPU tensor it runs its plain version,
``pack_frames_plain``: a bit array built with torch ops.  There is no
fallback between the two.

The result is one uint8 buffer: the two int32 status words (little-endian;
``split``), then the frames.  One download brings both to the host.

``launches`` counts K6's launches.
"""
import ctypes
import os
from functools import lru_cache

import torch

from ..runtime.profiling import span
from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "pack12.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libpack12.so")
NVCC_FLAGS = cuda_build.NVCC_FLAGS
#: the status words ahead of the frames in K6's buffer: the frames whose
#: lengths do not sum to their bits, the element lengths outside [0, 32]
STATUS_BYTES = 8

#: K6's launches
launches = 0


def build(force=False, extra_flags=()):
    """Compile csrc/pack12.cu into build/libpack12.so (if the library is
    missing or older than the source); returns nvcc's output."""
    return cuda_build.build(SOURCE, LIBRARY, NVCC_FLAGS + list(extra_flags),
                            force)


@lru_cache(maxsize=None)
def _library():
    build()
    lib = ctypes.CDLL(LIBRARY)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mp3_pack12.restype = i32
    lib.mp3_pack12.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 3
    return lib


def _check(values, lengths, frame_bytes, crc):
    if values.dim() != 2:
        raise ValueError(f"pack12: values must be (F, E), got "
                         f"{tuple(values.shape)}")
    shape = tuple(values.shape)
    for name, t in (("values", values), ("lengths", lengths)):
        cuda_build.check("pack12", name, t, torch.int32, shape,
                         values.device)
    if not 6 <= frame_bytes <= 8192:
        raise ValueError(f"pack12: frame_bytes {frame_bytes}")
    if crc is not None and not 0 <= crc[0] <= crc[1] <= shape[1]:
        raise ValueError(f"pack12: CRC elements {crc} of {shape[1]}")


def _launch(values, lengths, frame_bytes, crc):
    global launches
    _check(values, lengths, frame_bytes, crc)
    F, E = values.shape
    dev = values.device
    buf = torch.empty(STATUS_BYTES + F * frame_bytes, dtype=torch.uint8,
                      device=dev)
    buf[:STATUS_BYTES].zero_()
    if F:
        lib = _library()
        first, end = crc if crc is not None else (-1, -1)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mp3_pack12(values.data_ptr(), lengths.data_ptr(), F, E,
                                 frame_bytes, first, end,
                                 buf.data_ptr() + STATUS_BYTES,
                                 buf.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"pack12: kernel launch failed, CUDA error "
                               f"{err}")
        launches += 1
    return buf


def _crc_step(crc, bit):
    """One bit of CRC-16 (0x8005), as numpy_ref/layer12._update_crc."""
    carry = (crc >> 15) & 1
    crc = (crc << 1) & 0xFFFF
    return crc ^ torch.where((carry ^ bit) != 0, 0x8005, 0)


def pack_frames_plain(values, lengths, frame_bytes, crc=None):
    """K6's plain version, the same buffer from torch ops: every element's
    bits (its low `length` bits, MSB first) scattered at the exclusive
    cumsum of the frame's lengths into an (F, 8 * frame_bytes) bit array
    (bits past the frame's end dropped), the CRC run bit by bit over all
    frames at once, the bits packed into bytes."""
    _check(values, lengths, frame_bytes, crc)
    F, E = values.shape
    dev = values.device
    fbits = 8 * frame_bytes
    n = lengths.to(torch.int64)
    bad = (n < 0) | (n > 32)
    n = torch.where(bad, 0, n)
    off = torch.cumsum(n, dim=1) - n
    total = n.sum(dim=1)
    v = values.to(torch.int64) & 0xFFFFFFFF
    rows = torch.arange(F, device=dev)[:, None] * fbits
    dump = F * fbits                        # a slot for the dropped bits
    bits = torch.zeros(F * fbits + 1, dtype=torch.int64, device=dev)
    for j in range(32):
        pos = off + j
        keep = (j < n) & (pos < fbits)
        bit = (v >> (n - 1 - j).clamp(min=0)) & 1
        bits.scatter_(0, torch.where(keep, rows + pos, dump).reshape(-1),
                      bit.reshape(-1))
    bits = bits[:dump].reshape(F, fbits)
    frames = (bits.reshape(F, frame_bytes, 8)
              * (1 << torch.arange(7, -1, -1, device=dev))).sum(dim=2)
    if crc is not None and F:
        first, end = crc
        ends = torch.cat([off, total[:, None]], dim=1)
        start, stop = ends[:, first], ends[:, end].clamp(max=fbits)
        c = torch.full((F,), 0xFFFF, dtype=torch.int64, device=dev)
        for b in range(16, 32):
            c = _crc_step(c, bits[:, b])
        for t in range(int((stop - start).max().clamp(min=0))):
            at = start + t
            step = _crc_step(c, bits.gather(
                1, at.clamp(max=fbits - 1)[:, None])[:, 0])
            c = torch.where(at < stop, step, c)
        frames[:, 4] |= c >> 8
        frames[:, 5] |= c & 0xFF
    status = torch.stack([((total != fbits) | bad.any(dim=1)).sum(),
                          bad.sum()]).to(torch.int32)
    return torch.cat([status.view(torch.uint8),
                      frames.reshape(-1).to(torch.uint8)])


def split(buf):
    """(status (2,) int32, frames uint8) views of a K6 buffer on the host
    or the device."""
    return buf[:STATUS_BYTES].view(torch.int32), buf[STATUS_BYTES:]


def check_status(status):
    """Raise if K6's status words (from ``split``) report a frame whose
    lengths do not sum to its bits or an element length outside [0, 32]."""
    frames, lengths = (int(x) for x in status)
    if frames or lengths:
        raise RuntimeError(f"pack12: {frames} frame(s) whose element lengths "
                           f"do not sum to the frame's bits, {lengths} "
                           f"element length(s) outside [0, 32]")


@span("pack_elements")
def pack_frames(values, lengths, frame_bytes, crc=None):
    """Pack F frames of E elements each, every frame `frame_bytes` long:
    values and lengths (F, E) int32 (a value's low `length` bits are sent,
    MSB first); with `crc` = (first, end) element indices, the frame's
    CRC-16 over header bits 16-31 and the elements [first, end) goes into
    bits 32-47.  Returns the uint8 buffer of ``split`` on values' device:
    one K6 launch on a CUDA tensor, no wait on the host; the plain version
    on a CPU tensor."""
    if values.device.type == "cuda":
        return _launch(values, lengths, frame_bytes, crc)
    if values.device.type != "cpu":
        raise ValueError(f"pack12: unsupported device {values.device}")
    return pack_frames_plain(values, lengths, frame_bytes, crc)
