"""compress_p95_ms: the 95th percentile of every compress call's time, from its start to its returned
bytes, host clock, in ms."""

from perfbench import readers


def read(ctx):
    return readers.tail_ms(ctx, "compress")
