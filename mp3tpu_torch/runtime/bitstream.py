"""ctypes binding to the native bitstream assembler (csrc/mp3bits.cpp).

Builds the shared library from the package's own source on first use
(g++ -O3) and caches it under mp3tpu_torch/build/.
"""
import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "mp3bits.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")
_LIB = None


def _build():
    """Rebuild on demand when the source is newer; the library is written
    under a temporary name and renamed, so that processes building at
    the same time never load a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, "libmp3bits.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(_SRC)):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    global _LIB
    if _LIB is None:
        so = _build()
        lib = ctypes.CDLL(so)
        lib.mp3bits_create.restype = ctypes.c_void_p
        lib.mp3bits_create.argtypes = [ctypes.c_int] * 11 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.mp3bits_frame.restype = ctypes.c_int
        lib.mp3bits_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mp3bits_finish.restype = ctypes.c_long
        lib.mp3bits_finish.argtypes = [ctypes.c_void_p]
        lib.mp3bits_copy.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_ubyte)]
        lib.mp3bits_free.argtypes = [ctypes.c_void_p]
        lib.mp3bits_pack.restype = ctypes.c_long
        lib.mp3bits_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.POINTER(ctypes.c_ubyte)]
        lib.mp3bits_encode_clip_payload.restype = None
        lib.mp3bits_encode_clip_payload.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int]
        lib.mp3bits_encode_clip_payload_flat.restype = None
        lib.mp3bits_encode_clip_payload_flat.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_long)]
        lib.mp3resv_scan.restype = None
        lib.mp3resv_scan.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lib.mp3resv_guard.restype = ctypes.c_int
        lib.mp3resv_guard.argtypes = [
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long, ctypes.c_int, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.POINTER(ctypes.c_long)]
        lib.mp3bits_pending.restype = ctypes.c_long
        lib.mp3bits_pending.argtypes = [ctypes.c_void_p]
        lib.mp3bits_drain.restype = ctypes.c_long
        lib.mp3bits_drain.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        lib.mp3bits_ckpt_size.restype = ctypes.c_long
        lib.mp3bits_ckpt_size.argtypes = [ctypes.c_void_p]
        lib.mp3bits_ckpt_save.restype = None
        lib.mp3bits_ckpt_save.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        lib.mp3bits_ckpt_load.restype = None
        lib.mp3bits_ckpt_load.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        _LIB = lib
    return _LIB


def _lptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def resv_scan(pe, demand, p23, last_target, nframes, nch, mean_bits,
              resv_max, mode_gr=2, delta=0, size=None):
    """Native reservoir budget scan.  Arrays are (nch, G) and get
    transposed to the scan's granule-major (f, gr, ch) order.

    delta (mode 0): expected per-granule slack of reservoir-constrained
    granules, folded into the usage prediction so the recycling that
    would otherwise need a relax re-encode happens in the first scan
    (see csrc/mp3bits.cpp).

    size: carried reservoir level for STREAMING windows -- the scan is
    causal, so windowed scans with the carried level reproduce the
    whole-clip scan exactly.  When given, returns (budgets, new_size)."""
    lib = get_lib()

    def gm(a, dt=np.int64):           # (nch, G) -> granule-major flat
        return np.ascontiguousarray(np.asarray(a, dt).T.reshape(-1))

    pe_g = np.ascontiguousarray(np.asarray(pe, np.float64).T.reshape(-1))
    demand_g = gm(demand)
    budgets = np.zeros(pe_g.shape[0], np.int64)
    mode = 0 if last_target is None else 1
    p23_g = gm(p23 if p23 is not None else demand)
    lt_g = gm(last_target if last_target is not None else demand)
    sio = None
    if size is not None:
        sio = ctypes.c_long(int(size))
    lib.mp3resv_scan(
        pe_g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _lptr(demand_g), _lptr(p23_g), _lptr(lt_g), _lptr(budgets),
        nframes, nch, mean_bits, resv_max, mode, mode_gr, delta,
        ctypes.byref(sio) if sio is not None else None)
    out = budgets.reshape(-1, nch).T.copy()
    if size is not None:
        return out, int(sio.value)
    return out


def resv_guard(p23, nframes, nch, mean_bits, resv_max, mode_gr=2,
               size=None):
    """Native feasibility-limit scan; returns (bad, limits (nch, G)),
    plus the carried reservoir level when `size` is given (streaming
    windows)."""
    lib = get_lib()
    p23_g = np.ascontiguousarray(np.asarray(p23, np.int64).T.reshape(-1))
    limits = np.zeros(p23_g.shape[0], np.int64)
    sio = ctypes.c_long(int(size)) if size is not None else None
    bad = lib.mp3resv_guard(_lptr(p23_g), _lptr(limits), nframes, nch,
                            mean_bits, resv_max, mode_gr,
                            ctypes.byref(sio) if sio is not None else None)
    lims = limits.reshape(-1, nch).T.copy()
    if size is not None:
        return bool(bad), lims, int(sio.value)
    return bool(bad), lims


def guard_clamp(target, limits, retry, mean_bits, nch):
    """Shared budget-clamp ladder for the reservoir-guard retry loops
    (encoder / stream / sharded clip / corpus paths).

    retry 0/1: clamp to the guard's own per-granule limits minus a
    margin.  retry 2 (last resort, SURVEY.md section 5.3 recovery):
    clamp every granule under the per-channel frame mean -- feasible
    for ANY reservoir trajectory (limit = mean + size, size >= 0), so
    the following pass always converges and quality degrades gracefully
    instead of aborting.  The floor follows the mean at low bitrates
    (mean_bits//nch can be < 64 for e.g. 8-16 kbps LSF stereo; a fixed
    64-bit floor would exceed the guard limit and the 'guaranteed-
    feasible' pass could still fail)."""
    mean_share = mean_bits // nch
    floor = max(min(64, mean_share - 8), 1)
    if retry >= 2:
        return np.minimum(target, max(mean_share - 8, floor))
    return np.minimum(target, np.maximum(limits - 8, floor))


def pack_elements(values, lengths):
    """Pack a flat (value, nbits) element stream MSB-first -> bytes.

    values: uint32 array; lengths: int32 array (0-length elements are
    skipped).  Native C++ single pass.
    """
    lib = get_lib()
    values = np.ascontiguousarray(values, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    total_bits = int(lengths.sum())
    out = np.empty((total_bits + 7) // 8, np.uint8)
    n = lib.mp3bits_pack(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(values), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out[:n].tobytes()


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


class NativeAssembler:
    """Streaming frame assembler backed by the C++ engine."""

    def __init__(self, cfg, sfb_short):
        lib = get_lib()
        sfb = np.ascontiguousarray(sfb_short, np.int32)
        self._lib = lib
        self._h = lib.mp3bits_create(
            cfg.version, cfg.layer, cfg.bitrate_index,
            cfg.sampling_frequency, cfg.mode, cfg.mode_ext, cfg.emphasis,
            int(cfg.copyright), int(cfg.original),
            int(cfg.error_protection), cfg.private_bits, _ptr(sfb))
        self.nch = cfg.nchannels

    def add_frame(self, bits_per_frame, padding, main_data_begin, scfsi,
                  side, sfl, sfs, ix, resv_drain):
        """All array args contiguous int32; side (2*nch, 18), sfl
        (2*nch, 22), sfs (2*nch, 39), ix (2*nch, 576).
        Returns nextBackPtr."""
        return self._lib.mp3bits_frame(
            self._h, bits_per_frame, padding, main_data_begin,
            _ptr(scfsi), _ptr(side), _ptr(sfl), _ptr(sfs), _ptr(ix),
            resv_drain)

    def encode_clip_payload(self, nframes, bits_per_frame, mean_bits,
                            resv_max, scfsi, side, payload,
                            row_offsets=None):
        """Assemble a clip from device-packed granule payloads: exact
        reservoir stuffing plan + side-info weave + payload splice.
        side (nch, G, 19) with part2_3_length at [..., 0]; payload
        (nch, G, W) uint32 MSB-first word rows (ops/jaxbits.py), OR a
        device-compacted flat u32 buffer with row_offsets (nch*G,)
        giving each granule's start word (jaxbits.compact_payload)."""
        payload = np.ascontiguousarray(payload, np.uint32)
        if row_offsets is not None:
            offs = np.ascontiguousarray(row_offsets, np.int64).reshape(-1)
            self._lib.mp3bits_encode_clip_payload_flat(
                self._h, nframes, bits_per_frame, mean_bits, resv_max,
                _ptr(scfsi), _ptr(side),
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                _lptr(offs))
            return
        self._lib.mp3bits_encode_clip_payload(
            self._h, nframes, bits_per_frame, mean_bits, resv_max,
            _ptr(scfsi), _ptr(side),
            payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            payload.shape[-1])

    def checkpoint(self):
        """Serialize the weave state (reservoir level, back-pointer,
        bit-writer phase, pending bytes, queued side records)."""
        n = self._lib.mp3bits_ckpt_size(self._h)
        out = np.empty(n, np.uint8)
        self._lib.mp3bits_ckpt_save(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        return out.tobytes()

    def restore(self, blob):
        arr = np.frombuffer(blob, np.uint8)
        self._lib.mp3bits_ckpt_load(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))

    def drain(self):
        """Streaming: hand back (and free) every byte assembled so far
        -- memory stays bounded by one window."""
        n = self._lib.mp3bits_pending(self._h)
        out = np.empty(max(n, 1), np.uint8)
        got = self._lib.mp3bits_drain(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        return out[:got].tobytes()

    def finish(self):
        self._lib.mp3bits_finish(self._h)
        n = self._lib.mp3bits_pending(self._h)
        out = np.empty(max(n, 1), np.uint8)
        got = self._lib.mp3bits_drain(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        self._lib.mp3bits_free(self._h)
        self._h = None
        return out[:got].tobytes()
