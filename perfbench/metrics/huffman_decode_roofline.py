"""huffman_decode_roofline: kernel H's share of its roofline, in %: the least time of its work (each
container's payload and token bytes, perfbench/work_huffman.py) over the device time of its kernels."""

from perfbench import readers, work_huffman


def read(ctx):
    return readers.roofline_pct(ctx, "decompress", ("huffman_decode_kernel",),
                                lambda s: readers.least_s(*work_huffman.decode_work(s["tokens"], s["payload"],
                                                                                    s["blocks"])))
