"""huffman_tree_ms.decompress: host time of the program's rsnb.dec.tree range (each block's header read,
its Huffman tree and kernel H's child table), in ms a call. With two clients it holds each one's waits
for the interpreter lock while the other builds its trees."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, "decompress", "rsnb.dec.tree")
