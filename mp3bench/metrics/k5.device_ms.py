"""Summed device time of K5's events (``alloc12_kernel``, the Layer I/II
bit allocation), per minute of audio encoded in the traced window."""


def read(ctx):
    us = ctx.trace.device_us_of("alloc12_kernel")
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
