"""Device time of the events launched inside the staged graphs' spans
(``analyze_demand_fused``, ``outer_loop``, ``encode_final``,
``granule_payload``; ``ops/graphs.py``), per minute of audio encoded
in the traced window."""

SPANS = ["analyze_demand_fused", "outer_loop", "encode_final",
         "granule_payload"]


def read(ctx):
    us = ctx.trace.device_us_launched_in(SPANS)
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
