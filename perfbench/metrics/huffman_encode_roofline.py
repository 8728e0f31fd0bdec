"""huffman_encode_roofline: kernel G's share of its roofline, in %: the least time of its work (each
container's token and payload bytes, perfbench/work_huffman.py) over its device time."""

from perfbench import readers, work_huffman


def read(ctx):
    return readers.roofline_pct(ctx, "compress", ("huffman_encode_kernel",),
                                lambda s: readers.least_s(*work_huffman.encode_work(s["tokens"], s["payload"],
                                                                                    s["blocks"])))
