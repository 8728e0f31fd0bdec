"""decompress_MBps: input bytes of every decompress call, in 10^6 bytes, over the wall time of the decompress phase."""

from perfbench import readers


def read(ctx):
    return readers.rate_MBps(ctx, "decompress")
