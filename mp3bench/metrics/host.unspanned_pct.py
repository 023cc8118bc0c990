"""Share of the traced window in which the jobs' host thread was inside
no span of the program (``runtime.profiling.scope``: the named programs
of ``SPANS`` and ``SPANS_L12``, and any span added later)."""
from mp3bench.trace import clip, covered


def read(ctx):
    tr = ctx.trace
    if tr.window_us <= 0:
        return None
    inside = covered(clip([(s, e) for _, s, e in tr.spans], tr.lo, tr.hi))
    return 100.0 * (1.0 - inside / tr.window_us)
