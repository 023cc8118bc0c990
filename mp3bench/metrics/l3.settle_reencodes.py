"""Re-encodes in ``settle`` (``run_final`` spans: a wider payload row or
a guard retry) per minute of audio encoded in the traced window: 0.0
when the traced ``settle`` spans re-encoded nothing; nothing when the
trace holds no ``settle`` span to count in."""


def read(ctx):
    tr = ctx.trace
    if not ctx.audio_min or not tr.spans_named(["settle"]):
        return None
    n = sum(1 for s, _ in tr.spans_named(["run_final"])
            if tr.lo <= s < tr.hi)
    return n / ctx.audio_min
