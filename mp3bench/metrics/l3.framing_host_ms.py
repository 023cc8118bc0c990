"""Host time inside the ``frame`` spans (``_Layer3Framing.frame``: a
clip's orientation and channel checks, and for PCM that is not int16 its
sanitizing into int16; an int16 clip is handed on as a view of the
caller's samples), per minute of audio encoded in the traced window."""


def read(ctx):
    us = ctx.trace.host_us(["frame"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
