"""arith_decode_roofline: kernel C's share of its roofline, in %: the least time of its work (each
container's payload bytes and coder steps, perfbench/work.py) over its device time."""

from perfbench import readers, work


def read(ctx):
    return readers.roofline_pct(ctx, "decompress", ("arith_decode_kernel",),
                                lambda s: readers.least_s(*work.decode_work(readers.coded(s), s["payload"],
                                                                            s["blocks"])))
