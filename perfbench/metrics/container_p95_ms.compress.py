"""container_p95_ms.compress: the 95th percentile of every compress call's time, host clock, in ms."""

from perfbench import readers


def read(ctx):
    return readers.tail_ms(ctx, "compress")
