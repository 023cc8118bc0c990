"""Host time inside the segment program's spans (``encode_segment_fused``,
``models/layer3.py``), per minute of audio encoded in the traced
window."""


def read(ctx):
    us = ctx.trace.host_us(["encode_segment_fused"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
