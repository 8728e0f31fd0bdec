"""container_p95_ms.decompress: the 95th percentile of every decompress call's time, host clock, in ms."""

from perfbench import readers


def read(ctx):
    return readers.tail_ms(ctx, "decompress")
