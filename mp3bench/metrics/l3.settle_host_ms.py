"""Host time inside the ``settle`` spans (``_Layer3Framing.settle``: the
payload and reservoir guards, the payloads stitched for the assembler,
and every re-encode with its wait), per minute of audio encoded in the
traced window."""


def read(ctx):
    us = ctx.trace.host_us(["settle"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
