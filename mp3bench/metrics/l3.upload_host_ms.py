"""Host time inside the ``upload`` spans (a pinned buffer filled straight
from the clips' samples, a segment's blocks or a corpus segment's lanes,
and its queued upload), per minute of audio encoded in the traced
window.  ``dispatch_group.blocks``, a span that stacked a corpus group's
clips as lanes before the fill went straight into the pinned buffers,
is read too where a trace holds it."""

SPANS = ["upload", "dispatch_group.blocks"]


def read(ctx):
    us = ctx.trace.host_us(SPANS)
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
