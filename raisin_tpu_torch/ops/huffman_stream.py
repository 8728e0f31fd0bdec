"""Single-stream Huffman on the card: the port of raisin_tpu/ops/huffman_jax.py:compress (:142) and decompress (:192).

The ``device`` backend of ``huffman`` (``engine/registry.py``): one block of
the container's Huffman layer (``ops/huffman_blocks.py``), the whole input
at once. :func:`compress` counts the symbols on the card, builds the tree,
code table and header on the host and writes the payload with kernel G;
:func:`decompress` parses the header and builds the child table on the
host and walks the payload with kernel H.

An input with a byte >= 0x80 takes the format's own split to the port's
copy of the host oracle, counted in ``huffman_blocks.host_split`` as in the
container (the JAX package runs any rune on its device path; the bytes are
the same either way). Empty input raises the oracle's ValueError, and so
does the decode of a single-symbol stream, whose one code has no bits.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from raisin_tpu_torch.ops import huffman_blocks
from raisin_tpu_torch.ops.device import d2h, h2d, resolve_device


def compress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Exact `.rsn` Huffman encode; counts and kernel G on ``device``."""
    dev = resolve_device(device)
    with record_function("stream.enc.h2d"):
        x = h2d(data, dev)[None]
        n = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    with record_function("stream.enc.huffman"):
        flat, _ = huffman_blocks.encode_blocks(x, n)
    with record_function("stream.enc.d2h"):
        return d2h(flat)


def decompress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Exact `.rsn` Huffman decode; kernel H on ``device``.

    Every code has at least one bit, so the payload's bit count bounds the
    decoded symbols and sizes the output row.
    """
    dev = resolve_device(device)
    data = bytes(data)
    with record_function("stream.dec.h2d"):
        flat = h2d(data, dev)
    with record_function("stream.dec.huffman"):
        rows, counts, host = huffman_blocks.decode_blocks(
            flat, data, np.zeros(1, dtype=np.int64), np.array([len(data)], dtype=np.int64), 8 * len(data)
        )
    if host:
        return host[0]
    with record_function("stream.dec.d2h"):
        return d2h(rows[0, : int(counts[0])])
