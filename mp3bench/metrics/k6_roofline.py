"""K6's share of its bytes bound (``pack12_kernel``, the Layer II frame
packing with the CRC): the least time in which the card's HBM could
move what the traced jobs' frames hold -- each frame's bytes written
once, and its allocation, scfsi, scale factors and sample codes read
once at their coded widths, counted from the streams by the standard's
frame layout (``ref.layer2.coded_bits``) -- over K6's summed device
time."""
from mp3bench.peaks import HBM_BYTES_PER_S
from mp3bench.ref.layer2 import coded_bits


def k6_bytes(streams, config):
    """Bytes that K6 must move for these streams."""
    total = 0
    for s in streams:
        b = coded_bits(s, config)
        read = b["alloc"] + b["scfsi"] + b["scalefactors"] + b["samples"]
        total += int(b["frame"].sum()) // 8 + int(read.sum()) / 8
    return total


def read(ctx):
    us = ctx.trace.device_us_of("pack12_kernel")
    if not us or ctx.config["layer"] != 2:
        return None
    return 100.0 * k6_bytes(ctx.streams, ctx.config) / HBM_BYTES_PER_S \
        / (us / 1e6)
