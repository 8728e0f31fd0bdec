"""Single-stream Huffman on the card: the port of raisin_tpu/ops/huffman_jax.py:compress (:142) and decompress (:192).

The ``device`` backend of ``huffman`` (``engine/registry.py``), for any
input: the JAX package's device codec codes every rune, and so does this
one. Its bytes are the oracle's (``formats/huffman.py``), whose 900,000-rune
decode cap it does not keep, as the JAX device codec does not.

- An ASCII input is one block of the container's Huffman layer
  (``ops/huffman_blocks.py``), the whole input at once: :func:`compress`
  counts the bytes on the card, builds the tree, code table and header on
  the host and writes the payload with kernel G; :func:`decompress` parses
  the header and builds the child table on the host and walks the payload
  with kernel H.
- Any other input runs on its runes. Compress: Go's rune iteration on the
  card (``ops/runes.py``), ids and counts by ``torch.unique`` (an id is the
  rune's rank in ascending rune order), the tree, its wide tables
  (``huffman_blocks.wide_tables``) and the header on the host, then wide
  kernel G on the ids. Decompress, for a tree with a leaf >= 128: wide
  kernel H gives ids, a gather gives their runes and ``runes.encode_utf8``
  their UTF-8, all on the card.

Nothing here takes the container's host split (``huffman_blocks.host_split``
stays 0). Empty input raises the oracle's ValueError, and so does the
decode of a single-symbol stream, whose one code has no bits, and of a
stream the oracle cannot parse. A code past 32 bits raises the item-18
ValueError both ways (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from raisin_tpu_torch.formats import huffman as hf
from raisin_tpu_torch.ops import huffman_blocks, huffman_rows, runes
from raisin_tpu_torch.ops.device import d2h, h2d, resolve_device


def compress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Exact `.rsn` Huffman encode; counts and kernel G on ``device``."""
    dev = resolve_device(device)
    with record_function("stream.enc.h2d"):
        x = h2d(data, dev)
    if not bytes(data).isascii():
        return _compress_runes(x, dev)
    n = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    with record_function("stream.enc.huffman"):
        flat, _ = huffman_blocks.encode_blocks(x[None], n)
    with record_function("stream.enc.d2h"):
        return d2h(flat)


def _compress_runes(x: torch.Tensor, dev: torch.device) -> bytes:
    """The encode of an input with a byte >= 0x80: its runes through wide kernel G."""
    with record_function("stream.enc.runes"):
        r = runes.decode(x)
        uniq, ids, counts = torch.unique(r, sorted=True, return_inverse=True, return_counts=True)
        vals, cnt = uniq.cpu().numpy(), counts.cpu().numpy().astype(np.int64)
    with record_function("stream.enc.tree"):
        freqs = dict(zip(vals.tolist(), cnt.tolist()))
        tables = huffman_blocks.wide_tables(hf.build_tree(freqs))
        nbits = int((cnt * tables.code_lens).sum())
        prefix = hf.build_header(freqs) + hf.SEPARATOR
    with record_function("stream.enc.huffman"):
        rows, _, pads = huffman_rows.encode_rows_wide(
            ids.to(torch.int32).reshape(1, -1), torch.tensor([r.numel()], dtype=torch.int32, device=dev),
            torch.from_numpy(tables.codes).to(dev), torch.from_numpy(tables.code_lens).to(dev),
            max(1, -(-nbits // 32)), bits=torch.tensor([nbits], dtype=torch.int64, device=dev),
        )
        payload = torch.cat([pads[:1].to(torch.uint8), rows[0, : (nbits + 7) // 8]])
    with record_function("stream.enc.d2h"):
        return prefix + d2h(payload)


def _tree(data: bytes):
    """The stream's tree, or the oracle's error for what the card does not decode (no separator, no pad
    byte, a header the oracle cannot read, a single symbol)."""
    cut = data.find(hf.SEPARATOR)
    if cut >= 0 and cut + len(hf.SEPARATOR) < len(data):
        try:
            tree = hf.build_tree(hf.parse_header(data[:cut]))
        except ValueError:
            tree = None
        if tree is not None and not isinstance(tree, hf.Leaf):
            return tree, cut
    hf.decompress(data)  # raises: these cases end in an error before the oracle decodes a bit
    raise AssertionError("the oracle decoded a stream without a two-leaf tree")


def decompress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Exact `.rsn` Huffman decode; kernel H on ``device``.

    Every code has at least one bit, so the payload's bit count bounds the
    decoded symbols and sizes the output row.
    """
    dev = resolve_device(device)
    data = bytes(data)
    with record_function("stream.dec.tree"):
        tree, cut = _tree(data)
        tables = huffman_blocks.packed_table(tree)
    with record_function("stream.dec.h2d"):
        flat = h2d(data, dev)
    if tables is None:  # a leaf >= 128
        return _decompress_runes(tree, flat, data, cut + len(hf.SEPARATOR), dev)
    with record_function("stream.dec.huffman"):
        rows, counts, _ = huffman_blocks.decode_blocks(
            flat, data, np.zeros(1, dtype=np.int64), np.array([len(data)], dtype=np.int64), 8 * len(data)
        )
    with record_function("stream.dec.d2h"):
        return d2h(rows[0, : int(counts[0])])


def _decompress_runes(tree, flat: torch.Tensor, data: bytes, pad_at: int, dev: torch.device) -> bytes:
    """The decode of a tree with a leaf >= 128: wide kernel H, then ids -> runes -> UTF-8 on the card."""
    with record_function("stream.dec.tree"):
        tables = huffman_blocks.wide_tables(tree)
    with record_function("stream.dec.huffman"):
        blen = len(data) - pad_at - 1
        capb = max(4, -(-blen // 4) * 4)
        prow = torch.zeros((1, capb), dtype=torch.uint8, device=dev)
        prow[0, :blen] = flat[pad_at + 1 :]
        nbits = max(0, 8 * blen - data[pad_at])
        ids, counts, ok = huffman_rows.decode_rows_wide(
            prow, torch.tensor([data[pad_at]], dtype=torch.int32, device=dev),
            torch.tensor([blen], dtype=torch.int32, device=dev), torch.from_numpy(tables.children).to(dev),
            tables.lattice, nbits // int(tables.code_lens.min()) + 1,
        )
        n, ok = (int(v) for v in torch.stack([counts[0], ok[0]]).cpu())
    if not ok:
        raise ValueError("huffman: bitstream ends inside a code")
    with record_function("stream.dec.runes"):
        out = runes.encode_utf8(torch.from_numpy(tables.vals).to(dev)[ids[0, :n].to(torch.int64)])
    with record_function("stream.dec.d2h"):
        return d2h(out)
