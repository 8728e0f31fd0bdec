"""huffman_tree_ms.compress: host time of the program's rsnb.enc.tree range (each block's Huffman tree,
code table and header), in ms a call. With two clients it holds each one's waits for the interpreter
lock while the other builds its trees."""

from perfbench import spans


def read(ctx):
    return spans.host_ms(ctx, "compress", "rsnb.enc.tree")
