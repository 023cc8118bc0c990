"""Replays of the Layer I/II back half's CUDA graph (the captured stage
"l12_back" of ``graphs.graph_counts``) per job traced: 1.0 when every
traced item replays it; nothing when the program has no such stage."""


def read(ctx):
    counts = ctx.counters.get("l12_back")
    if counts is None or not ctx.jobs:
        return None
    return counts["replays"] / ctx.jobs
