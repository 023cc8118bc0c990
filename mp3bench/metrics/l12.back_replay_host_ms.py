"""Host time inside the ``_layer12_back`` spans (the Layer I/II back half:
on a CUDA device with psy model 2 the back half's graph replayed and K6's
buffer copied out, op by op otherwise), per minute of audio encoded in
the traced window; nothing when the trace holds no such span."""


def read(ctx):
    us = ctx.trace.host_us(["_layer12_back"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
