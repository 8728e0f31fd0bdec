"""arith_encode_roofline: kernels A and B's share of their roofline, in %: the least time of their
work (coder steps and payload bytes of each container, perfbench/work.py) over their device time."""

from perfbench import readers, work


def least(s):
    return (readers.least_s(*work.encode_work(readers.coded(s), s["payload"], s["blocks"]))
            + readers.least_s(*work.prepad_work(s["payload"], s["payload"], s["blocks"])))


def read(ctx):
    return readers.roofline_pct(ctx, "compress", ("arith_encode_kernel", "arith_prepad_kernel"), least)
