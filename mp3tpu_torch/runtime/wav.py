"""WAV / raw PCM / AIFF audio input-output.

The reference reads WAV by skipping a fixed 0x2c-byte header and trusts
the CLI -s flag for the sample rate (musicin.c:352-368).  We parse the
RIFF header properly, but ``read_wav_refcompat`` reproduces the
reference behavior for golden testing.
"""
import struct

import numpy as np


def write_wav(path, pcm, sample_rate):
    """pcm: (nsamples, nch) int16."""
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    nch = pcm.shape[1]
    data = pcm.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, nch, int(sample_rate),
                            int(sample_rate) * nch * 2, nch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path):
    """Proper RIFF parse. Returns (pcm (nsamples, nch) int16, rate)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        assert riff[:4] == b"RIFF" and riff[8:12] == b"WAVE", "not a WAV file"
        rate, nch, bits = None, None, None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            ckid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if ckid == b"fmt ":
                fmt = f.read(size)
                _, nch, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
            elif ckid == b"data":
                data = f.read(size)
            else:
                f.seek(size, 1)
        assert bits == 16, "only 16-bit PCM supported"
        pcm = np.frombuffer(data, "<i2").reshape(-1, nch)
        return pcm, rate


def read_wav_refcompat(path):
    """Reference-compatible read: skip 0x2c bytes, LE shorts
    (musicin.c:352-368; rate must come from the caller)."""
    with open(path, "rb") as f:
        raw = f.read()
    return np.frombuffer(raw[0x2C:], "<i2")
