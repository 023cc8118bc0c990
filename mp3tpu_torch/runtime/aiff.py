"""AIFF input support (aiff_read_headers / aiff_check equivalents,
common.c:636-698 + ieeefloat.c ConvertFromIeeeExtended :329).

Parses FORM/COMM/SSND chunks of a 16-bit PCM AIFF file and returns the
deinterleaved samples; the 80-bit SANE extended sample rate converts in
a few lines of Python.
"""
import struct

import numpy as np


def _from_ieee_extended(b):
    """80-bit SANE extended -> float (ieeefloat.c:329-354)."""
    expon = ((b[0] & 0x7F) << 8) | b[1]
    hi = struct.unpack(">I", b[2:6])[0]
    lo = struct.unpack(">I", b[6:10])[0]
    if expon == 0 and hi == 0 and lo == 0:
        f = 0.0
    else:
        expon -= 16383
        f = hi * 2.0 ** (expon - 31) + lo * 2.0 ** (expon - 63)
    return -f if (b[0] & 0x80) else f


def read_aiff(path_or_file):
    """Returns (pcm int16 (nsamples, nch), sample_rate float).

    Raises ValueError if not an AIFF or not 16-bit PCM mono/stereo.
    """
    f = (open(path_or_file, "rb")
         if isinstance(path_or_file, (str, bytes)) else path_or_file)
    data = f.read()
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] != b"AIFF":
        raise ValueError("not an AIFF file")
    pos = 12
    nch = rate = nframes = ssnd = None
    while pos + 8 <= len(data):
        ckid = data[pos:pos + 4]
        cksz = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + cksz]
        if ckid == b"COMM":
            nch, nframes, bits = struct.unpack(">hIh", body[:8])
            if bits != 16:
                raise ValueError("AIFF sound data is not 16 bits")
            rate = _from_ieee_extended(body[8:18])
        elif ckid == b"SSND":
            offset, blocksize = struct.unpack(">II", body[:8])
            if offset or blocksize:
                raise ValueError("AIFF block offset/size not 0")
            ssnd = body[8:]
        pos += 8 + cksz + (cksz & 1)
    if nch is None or ssnd is None:
        raise ValueError("AIFF missing COMM or SSND chunk")
    if nch not in (1, 2):
        raise ValueError("AIFF sound data is not mono or stereo")
    pcm = np.frombuffer(ssnd[:2 * nch * nframes], dtype=">i2")
    return pcm.astype(np.int16).reshape(-1, nch), float(rate)
