"""Host time inside the ``_layer12_frame`` spans (a Layer I/II item's PCM
to whole frames, int16 kept), per minute of audio encoded in the traced
window."""


def read(ctx):
    us = ctx.trace.host_us(["_layer12_frame"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
