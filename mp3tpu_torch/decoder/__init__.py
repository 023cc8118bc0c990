"""Host-side reference decoders (pure NumPy) for the test harness.

The reference encoder repo ships no working decoder (its decode-loop
remnants are dead code, SURVEY.md section 2.2); these implement ISO
11172-3 / 13818-3 decoding for Layers I/II/III, MPEG-1 and MPEG-2 LSF.
"""


def decode_mp3(data):
    """Decode any supported elementary stream -> (pcm, rate_hz).
    Dispatches on the first frame header's layer bits."""
    layer = 4 - ((data[1] >> 1) & 3)
    if layer == 3:
        from .layer3 import decode_mp3 as _l3
        return _l3(data)
    from .layer12 import decode
    return decode(data)
