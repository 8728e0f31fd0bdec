"""device_idle_pct.decompress: the share of the decompress phase, in %, in which the card ran nothing (the mean of
the cell's cards)."""

from perfbench import readers, stats


def read(ctx):
    t = readers.trace(ctx, "decompress")
    return None if t is None else stats.idle_pct(t.busy_s(), t.window_s())
