"""compress_MBps: input bytes of every compress call, in 10^6 bytes, over the wall time of the compress phase."""

from perfbench import readers


def read(ctx):
    return readers.rate_MBps(ctx, "compress")
