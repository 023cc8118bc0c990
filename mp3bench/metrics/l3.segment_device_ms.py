"""Device time of the events launched inside ``encode_segment_fused``
spans (the segment graph's replays), per minute of audio encoded in the
traced window."""


def read(ctx):
    us = ctx.trace.device_us_launched_in(["encode_segment_fused"])
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
