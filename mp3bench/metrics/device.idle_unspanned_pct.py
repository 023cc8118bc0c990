"""Share of the traced window in which the device ran no kernel, copy or
memset and the jobs' host thread was inside no span of the program: the
idle time that no span explains."""
from mp3bench.trace import clip, covered


def read(ctx):
    tr = ctx.trace
    if tr.window_us <= 0 or not tr.device:
        return None
    spans = clip([(s, e) for _, s, e in tr.spans], tr.lo, tr.hi)
    return 100.0 * (1.0 - covered(tr.busy() + spans) / tr.window_us)
