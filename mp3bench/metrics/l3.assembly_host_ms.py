"""Host time inside the ``native assembly`` spans (the Layer III frame
loop of ``csrc/mp3bits.cpp``), per minute of audio encoded in the
traced window."""


def read(ctx):
    us = ctx.trace.host_us(["native assembly"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
