"""Host time inside the Layer I/II back half's spans
(``greedy_allocation``, ``quantize_l2``, ``_marshal_layer12``,
``pack_elements``), per minute of audio encoded in the traced window."""

SPANS = ["greedy_allocation", "quantize_l2", "_marshal_layer12",
         "pack_elements"]


def read(ctx):
    us = ctx.trace.host_us(SPANS)
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
