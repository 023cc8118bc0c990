"""Host time inside the ``frame`` spans (``_Layer3Framing.frame``: a
clip's PCM to int16 frames through float32, ``nan_to_num``, the clip and
the pad), per minute of audio encoded in the traced window."""


def read(ctx):
    us = ctx.trace.host_us(["frame"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
