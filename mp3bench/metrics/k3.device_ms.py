"""Summed device time of K3's events (``search_kernel``, the rate loop's
stepsize searches), per minute of audio encoded in the traced window."""


def read(ctx):
    us = ctx.trace.device_us_of("search_kernel")
    return us / 1e3 / ctx.audio_min if us and ctx.audio_min else None
