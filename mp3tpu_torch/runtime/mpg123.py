"""ctypes binding to the system libmpg123: an INDEPENDENT,
industry-standard decoder for conformance checks.

The repo's own decoder (mp3tpu.decoder) shares no code with mpg123, but
it was written from the same spec by the same project -- a shared
misreading would be invisible to the SNR gates.  Decoding the encoder's
output with mpg123 closes that loop (the reference lineage's historical
check was the ASCII-bitstream diff against ISO decoders, common.h:254;
this is the modern equivalent).

Gracefully reports unavailability (no hard dependency): callers skip.
"""
import ctypes
import ctypes.util

import numpy as np

_OK = 0
_NEED_MORE = -10
_NEW_FORMAT = -11
_DONE = -12

# signed 16-bit: MPG123_ENC_SIGNED_16 (fmt123.h)
_ENC_SIGNED_16 = 0xD0

_LIB = None        # tri-state: None = not tried, False = load failed
_INIT = False


def available():
    return _load() is not None


def _load():
    global _LIB, _INIT
    if _LIB is not None:
        # False caches a FAILED load: the find_library probe shells
        # out, and callers re-check availability once per fixture
        return _LIB or None
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        _LIB = False
        return None
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.mpg123_read.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_ubyte),
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    if not _INIT:
        lib.mpg123_init()
        _INIT = True
    _LIB = lib
    return lib


def decode(data):
    """Decode an MPEG audio elementary stream with libmpg123.

    Returns (pcm int16 (n, nch), rate_hz).  Raises RuntimeError if the
    library is unavailable or the stream is rejected.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    mh = lib.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open_feed(mh) != _OK:
            raise RuntimeError("mpg123_open_feed failed")
        if lib.mpg123_feed(mh, bytes(data), len(data)) != _OK:
            raise RuntimeError("mpg123_feed failed")
        out = np.zeros(1 << 16, np.uint8)
        done = ctypes.c_size_t(0)
        rate = ctypes.c_long(0)
        nch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        chunks = []
        while True:
            rc = lib.mpg123_read(
                mh, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                out.nbytes, ctypes.byref(done))
            if done.value:
                chunks.append(out[:done.value].copy())
            if rc == _NEW_FORMAT:
                lib.mpg123_getformat(mh, ctypes.byref(rate),
                                     ctypes.byref(nch), ctypes.byref(enc))
                continue
            if rc == _OK:
                continue
            if rc in (_NEED_MORE, _DONE):
                break
            raise RuntimeError(
                "mpg123_read: "
                + lib.mpg123_plain_strerror(rc).decode())
        if not chunks or nch.value == 0:
            raise RuntimeError("mpg123 produced no audio")
        if enc.value != _ENC_SIGNED_16:
            # a float/8-bit-negotiated build would make the int16 view
            # below silently reinterpret the bytes
            raise RuntimeError(
                f"mpg123 negotiated encoding 0x{enc.value:x}, "
                f"need signed-16 (0x{_ENC_SIGNED_16:x})")
        pcm = np.concatenate(chunks).view(np.int16)
        return pcm.reshape(-1, nch.value), int(rate.value)
    finally:
        lib.mpg123_delete(mh)
