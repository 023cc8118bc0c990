"""Share of the traced window in which no kernel, copy or memset ran on
the device (the union of the device events' intervals)."""


def read(ctx):
    tr = ctx.trace
    if tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - sum(e - s for s, e in tr.busy()) / tr.window_us)
