"""Host time inside the ``upload`` spans (host copies into pinned
buffers and their queued uploads) and the ``dispatch_group.blocks``
spans (a corpus group's clips stacked as lanes), per minute of audio
encoded in the traced window."""

SPANS = ["upload", "dispatch_group.blocks"]


def read(ctx):
    us = ctx.trace.host_us(SPANS)
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
