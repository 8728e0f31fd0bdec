"""arith_events_roofline: kernel I's share of its roofline, in %: the least time of its work (a coder
step a byte of the LZSS stream and EOF, the stream's bits, perfbench/work.py) over the device time of
its three kernels."""

from perfbench import readers, work


def read(ctx):
    return readers.roofline_pct(ctx, "compress", ("arith_events_kernel",),
                                lambda s: readers.least_s(*work.events_work(s["lzss"] + 1, 8 * s["stream"])))
