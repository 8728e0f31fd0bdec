"""lzss_match_roofline: kernel D's share of its roofline, in %: the least time of its work (the
escaped input bytes: 9 bytes and log2(window) operations a byte, perfbench/work.py) over its device
time, in the compress phase."""

from perfbench import readers, work


def read(ctx):
    window = ctx.config["window"]
    return readers.roofline_pct(ctx, "compress", ("lzss_match_kernel",),
                                lambda s: readers.least_s(*work.match_work(s["escaped"], window)))
