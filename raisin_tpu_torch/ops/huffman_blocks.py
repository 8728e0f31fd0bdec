"""Block-parallel Huffman for the RSNB container: the port of raisin_tpu/ops/huffman_blocks.py.

The split of labour is the JAX package's: the per-block tree is built on
the host from the block's symbol counts, and the work over every byte runs
on the card, all blocks of a batch in one launch: kernel G
(:func:`huffman_rows.encode_rows`) writes the payloads, kernel H
(:func:`huffman_rows.decode_rows`) walks them back. The trees of a batch
(Go's container/heap mechanics in C, the trees of
``formats/huffman.build_tree``) and the card blocks' headers (the text of
``build_header`` and ``read_header``) come from the native runtime, a call
a batch, which runs without the interpreter lock, so that two callers' trees
do not wait for each other; no Python runs per card block.

- Encode (:func:`encode_blocks`): one ``scatter_add_`` into a (B, 256)
  table counts every block's symbols on the card (faster on an H100 than a
  ``torch.bincount`` over ``block * 256 + byte``, whose bins contend more);
  one copy brings the table to the host. From it the host builds every
  block's tree and code table, exact bit count (so rows are sized exactly)
  and header (:func:`code_tables`). The headers come back to the card as one
  buffer, and each block's payload (header, separator, pad byte, bits) is
  framed there.
- Decode (:func:`decode_blocks`): the host reads every block's header and
  builds its tree and packed child table (``native.huffman_read_headers``);
  the oracle decodes a block that call does not take. The payload rows are
  cut on the card from the container's body; the pad byte gives the start
  bit.

A block with a byte >= 0x80 is coded as ``formats/huffman.compress_block``
codes it. Where its bytes are valid UTF-8, Go's rune iteration gives them
back but differs from byte iteration (huffman.go:306-310), so the port's
copy of the host oracle codes it whole, as the JAX package's container does
(it gates its device path to ASCII blocks, raisin_tpu/ops/huffman_blocks.py:18-22).
Elsewhere Go's runes would lose bytes, and the block is coded over its
bytes: on the card, where its symbols leave an ASCII id free (never 0) for
each byte >= 0x80 (:func:`ascii_ids`), which the kernels then take in its
place; kernel H's rows are mapped back. That is the ``lzss,huffman`` text
block with a ``<``, which the LZSS escape writes as 0xFF. A byte-coded block
with too many symbols takes the oracle too. ``host_split`` counts the
blocks that take the oracle. The single stream
(``ops/huffman_stream.py``) never takes the split: it codes runes, and
codes past 32 bits, with :func:`wide_tables` and the wide kernels G and H.
Everything else decodes or raises as ``raisin_tpu.ops.huffman_blocks``
does: an empty block raises the oracle's error, a code past 32 bits
"huffman: code length beyond 32 bits", a single-symbol tree (zero-length
code) the oracle's "not decodable", a header the oracle cannot read the
oracle's message, and a walk that does not end at the root "huffman:
bitstream ends inside a code". A single-symbol block encodes on the card
(no bits, pad 0), where the JAX package calls the oracle; the bytes are
the same.

Each stage runs in its own ``record_function`` range: ``rsnb.enc.count``,
``rsnb.enc.tree`` (host), ``rsnb.enc.huffman`` (kernel G),
``rsnb.enc.hframe`` (the payloads framed on the card); ``rsnb.dec.tree``
(host), ``rsnb.dec.rows``, ``rsnb.dec.huffman`` (kernel H and its ``ok``
flags). Every read of a card value and every copy from pageable memory
runs inside an ``ops/device.sync`` range. ``native_headers`` counts the card
blocks whose header the native runtime wrote or read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from raisin_tpu_torch import native
from raisin_tpu_torch.formats import huffman as hf
from raisin_tpu_torch.ops import _build, huffman_rows
from raisin_tpu_torch.ops.device import sync

# bytes that begin and continue no valid UTF-8 sequence: a block holding one is byte-coded
NEVER_UTF8 = np.array([0xC0, 0xC1, *range(0xF5, 0x100)])
# blocks that took the host oracle since the last reset, per direction
host_split = {"encode": 0, "decode": 0}
# card blocks whose header the native runtime wrote (encode) or read (decode) since the last reset
native_headers = {"encode": 0, "decode": 0}


def reset_host_split() -> None:
    host_split["encode"] = host_split["decode"] = 0


def reset_native_headers() -> None:
    native_headers["encode"] = native_headers["decode"] = 0


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: from pageable memory, a copy that waits for the card's queue."""
    with sync("h2d"):
        return torch.from_numpy(a).to(dev)


def ascii_ids(symbols) -> np.ndarray | None:
    """(256,) uint8: the id kernels G and H take for each byte of a byte-coded block with these
    symbols. An ASCII byte is its own id; each byte >= 0x80 takes an ASCII value that is no symbol,
    from 127 down and never 0 (so a row's zero padding maps to itself); None where too few are free."""
    used = set(symbols)
    high = sorted(v for v in used if v >= huffman_rows.NSYM)
    free = [v for v in range(huffman_rows.NSYM - 1, 0, -1) if v not in used]
    if len(high) > len(free):
        return None
    ids = np.arange(256, dtype=np.uint8) % huffman_rows.NSYM
    ids[high] = free[: len(high)]
    return ids


def packed_table(tree) -> np.ndarray | None:
    """Kernel H's (64,) int32 child table for an ASCII tree; None for a non-ASCII one.

    The layout of ``raisin_tpu.ops.huffman_blocks._packed_table``: internal
    nodes are numbered 0..126 in preorder (root 0); word j holds nodes 2j
    (low half) and 2j + 1, each as ``left | right << 8``; a leaf's entry is
    128 + its symbol.
    """
    words = [0] * huffman_rows.NTAB
    counter = 0
    stack = [(tree, -1, 0)]  # (subtree, parent id, side) in preorder
    while stack:
        t, parent, side = stack.pop()
        if isinstance(t, hf.Leaf):
            if not 0 <= t.value < huffman_rows.NSYM:
                return None
            ref = huffman_rows.NSYM + t.value
        else:
            ref = counter
            counter += 1
            stack.append((t.right, ref, 1))
            stack.append((t.left, ref, 0))
        if parent >= 0:
            words[parent // 2] |= ref << (16 * (parent % 2) + 8 * side)
    return np.array(words, dtype=np.uint32).view(np.int32)


class WideTables(NamedTuple):
    """A tree's tables for the wide kernels, its leaves as ids: an id is the rank of the leaf's rune in
    ascending rune order, which is the header's order (``formats/huffman.build_header``)."""

    vals: np.ndarray  # (K,) int64, the runes in ascending order: id -> rune
    codes: np.ndarray | None  # (K, W) int32, each id's code left-aligned in W words (None: not asked for)
    code_lens: np.ndarray  # (K,) int32
    children: np.ndarray  # (2 * (K - 1),) int32: internal nodes in preorder (root 0), LEAF | id for a leaf
    lattice: int  # the greatest common divisor of the code lengths (0 for a single leaf)
    longest: int  # the longest code's bits, the tree's depth


def code_words(longest: int) -> int:
    """The 32-bit words a wide code table gives each code: the fewest of ``huffman_rows.CODE_WORDS``
    that hold ``longest`` bits. Past STREAM_CODE_BITS, the JAX stream's error
    (raisin_tpu/ops/huffman_jax.py:38)."""
    for w in huffman_rows.CODE_WORDS:
        if longest <= 32 * w:
            return w
    raise ValueError(f"huffman: code length beyond {huffman_rows.STREAM_CODE_BITS} bits")


def _left_aligned(codes: list[int], depths: list[int], words: int) -> np.ndarray:
    """(K, words) int32: each code left-aligned in ``words`` 32-bit words, first bit most significant."""
    if words <= 2:  # the codes fit 64 bits
        c, d = np.array(codes, dtype=np.uint64), np.array(depths, dtype=np.uint64)
        v = np.where(d > 0, c << (np.uint64(64) - d) % np.uint64(64), np.uint64(0))
        pair = np.stack([v >> np.uint64(32), v & np.uint64(0xFFFFFFFF)], axis=1).astype(np.uint32)
        return np.ascontiguousarray(pair[:, :words]).view(np.int32)
    width = 32 * words
    out = np.array([[(c << (width - d)) >> (32 * (words - 1 - j)) & 0xFFFFFFFF for j in range(words)]
                    for c, d in zip(codes, depths)], dtype=np.uint32).reshape(len(codes), words)
    return out.view(np.int32)


def longest_code(tree) -> int:
    """The tree's depth: its longest code's bits."""
    deepest, stack = 0, [(tree, 0)]
    while stack:
        t, depth = stack.pop()
        if isinstance(t, hf.Leaf):
            deepest = max(deepest, depth)
        else:
            stack += [(t.left, depth + 1), (t.right, depth + 1)]
    return deepest


def wide_tables(tree, codes: bool = True) -> WideTables:
    """The code table and child table of a tree whose leaves are runes (kernels G and H, wide).

    The code table (``codes``) takes as many words as the longest code needs
    (:func:`code_words`), and a code past STREAM_CODE_BITS raises the JAX
    stream's ValueError, as its compress does; with ``codes=False`` (the
    decode's tables) a tree of any depth passes and ``codes`` is None.
    """
    values, code_ints, depths = [], [], []
    children: list[int] = []
    leaf_slots: list[tuple[int, int]] = []  # (slot in children, index into values)
    stack = [(tree, -1, 0, 0)]  # (subtree, slot its reference goes to, code, depth) in preorder
    while stack:
        t, slot, code, depth = stack.pop()
        if isinstance(t, hf.Leaf):
            if slot >= 0:
                leaf_slots.append((slot, len(values)))
            values.append(t.value)
            code_ints.append(code)
            depths.append(depth)
            continue
        node = len(children) // 2
        if slot >= 0:
            children[slot] = node
        children += [0, 0]
        stack.append((t.right, 2 * node + 1, 2 * code + 1, depth + 1))
        stack.append((t.left, 2 * node, 2 * code, depth + 1))
    longest = max(depths)
    vals = np.array(values, dtype=np.int64)
    order = np.argsort(vals, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    table = np.array(children, dtype=np.int64)
    if leaf_slots:
        slots, leaves = np.array(leaf_slots, dtype=np.int64).T
        table[slots] = huffman_rows.LEAF | rank[leaves]
    return WideTables(
        vals[order],
        _left_aligned(code_ints, depths, code_words(longest))[order] if codes else None,
        np.array(depths, dtype=np.int32)[order],
        table.astype(np.uint32).view(np.int32),
        math.gcd(*depths),
        longest,
    )


# ---------------------------------------------------------------------------
# Encode


def count_symbols(x: torch.Tensor, lengths: torch.Tensor) -> np.ndarray:
    """(B, 256) int64 counts of every block's bytes: one scatter-add on the device, one copy back."""
    S = x.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < lengths.to(torch.int64)[:, None]
    counts = torch.zeros((x.shape[0], 256), dtype=torch.int32, device=x.device)
    counts.scatter_add_(1, x.to(torch.int64), valid.to(torch.int32))
    with sync("d2h"):
        return counts.cpu().numpy().astype(np.int64)


def code_tables(counts: np.ndarray, raw: np.ndarray | None = None) -> native.EncodeTables:
    """Each card block's code table and header, built on the host from its counts.

    ``raw`` marks the blocks coded over their bytes; the others are ASCII or
    take the oracle. One native call a batch (``native.huffman_encode_tables``)
    builds every block's tree, Go's, its codes, exact bit count and header:
    ``heads[b]`` ends with the block's ``formats/huffman.build_header`` and
    separator. The oracle codes the blocks ``on_host``: a byte >= 0x80 in a
    block not in ``raw``, or a byte-coded block with no :func:`ascii_ids`;
    their tables stay zero. A byte-coded card block's codes lie at its bytes'
    :func:`ascii_ids`. Raises ValueError, with the JAX container's message,
    for a code longer than CONTAINER_CODE_BITS.
    """
    t = native.huffman_encode_tables(counts, np.zeros(len(counts), dtype=bool) if raw is None else raw)
    if t.longest > huffman_rows.CONTAINER_CODE_BITS:
        raise ValueError(f"huffman: code length beyond {huffman_rows.CONTAINER_CODE_BITS} bits")
    return t


def _rows(x: torch.Tensor, blocks: np.ndarray) -> dict[int, np.ndarray]:
    """The rows ``blocks`` of ``x`` on the host, by block."""
    if not blocks.size:
        return {}
    picked = x[_to(blocks, x.device)]
    with sync("d2h"):
        return dict(zip(blocks.tolist(), picked.cpu().numpy()))


def encode_blocks(x: torch.Tensor, lengths: torch.Tensor):
    """Exact per-block `.rsn` Huffman payloads of B blocks.

    Args:
      x: (B, S) uint8 block bytes on the device (what lies past ``lengths``
        is ignored).
      lengths: (B,) int32 on the same device.

    Returns (flat, sizes): every block's payload concatenated in block
    order (uint8, on the device) and each payload's length (np.int64).
    Raises ValueError for an empty block and, with the JAX container's
    message, for a code longer than CONTAINER_CODE_BITS.
    """
    dev = x.device
    B = x.shape[0]
    with record_function("rsnb.enc.count"):
        counts = count_symbols(x, lengths)
    n = counts.sum(1)
    if (n == 0).any():
        hf.compress(b"")  # raises the oracle's error
    with record_function("rsnb.enc.tree"):
        # a block with a byte >= 0x80 that may be UTF-8 is read, and byte-coded where it is not
        wide = counts[:, huffman_rows.NSYM :].any(1)
        raw = counts[:, NEVER_UTF8].any(1)
        read = _rows(x, np.nonzero(wide & ~raw)[0])
        for b, row in read.items():
            raw[b] = not hf.go_lossless(row[: n[b]].tobytes())
        t = code_tables(counts, raw)
    _build.count(native_headers, "encode", B - int(t.on_host.sum()))
    heads, pre_lens = t.heads, t.head_lens.copy()
    host = np.nonzero(t.on_host)[0]
    if host.size:
        _build.count(host_split, "encode", int(host.size))
        read.update(_rows(x, host[~np.isin(host, list(read))]))
        payloads = {b: hf.compress_block(read[b][: n[b]].tobytes()) for b in host.tolist()}
        for b, p in payloads.items():
            pre_lens[b] = len(p)
        heads = np.pad(heads, ((0, 0), (int(pre_lens.max()) - heads.shape[1], 0)))
        for b, p in payloads.items():
            heads[b, heads.shape[1] - len(p) :] = np.frombuffer(p, dtype=np.uint8)
    want = (t.nbits + 7) // 8
    with record_function("rsnb.enc.huffman"):
        which = np.nonzero(raw & ~t.on_host)[0]
        if which.size:
            # the byte-coded blocks' bytes as their ids
            at = _to(which, dev)
            x = x.index_copy(0, at, _to(t.ids[which], dev).gather(1, x[at].to(torch.int64)))
        # kernel G places the codes behind the pad of these totals and raises where its own differ
        rows, _, pads = huffman_rows.encode_rows(
            x, lengths, _to(t.codes.view(np.int32), dev), _to(t.code_lens, dev),
            max(1, int(want.max() + 3) // 4), bits=_to(t.nbits, dev),
        )
    with record_function("rsnb.enc.hframe"):
        # row b: [prefix, right-aligned][pad byte][payload]; a host block's prefix is its whole payload
        P = heads.shape[1]
        tail = np.where(t.on_host, 0, 1 + want)
        framed = torch.cat([_to(heads, dev), pads.to(torch.uint8)[:, None], rows], dim=1)
        cols = torch.arange(framed.shape[1], device=dev)[None, :]
        lo = _to(P - pre_lens, dev)[:, None]
        hi = _to(P + tail, dev)[:, None]
        with sync("mask"):
            flat = framed[(cols >= lo) & (cols < hi)]
    return flat, pre_lens + tail


# ---------------------------------------------------------------------------
# Decode


def decode_blocks(flat: torch.Tensor, data: bytes, starts: np.ndarray, sizes: np.ndarray, cap_out: int,
                  first_block: int = 0):
    """Decode B `.rsn` Huffman payloads.

    Args:
      flat: the payloads concatenated, on the device (uint8).
      data: bytes holding the same payloads for the host, block b at
        ``data[starts[b] : starts[b] + sizes[b]]``.
      starts, sizes: (B,) int64.
      cap_out: decoded bytes a row holds (the container's bound on a block's
        output); rounded up to a multiple of 4.
      first_block: the container index of block 0, for error messages.

    Returns (rows, counts, host): rows (B, cap) uint8 on the device and
    counts (B,) np.int64 of the blocks that the card decoded (a count above
    ``cap`` means the row lost the rest), and ``host``, a dict block ->
    decoded bytes of the blocks that took the host oracle (their rows are
    empty). Raises the JAX package's errors.
    """
    dev = flat.device
    B = len(sizes)
    host: dict[int, bytes] = {}
    with record_function("rsnb.dec.tree"):
        # the card blocks' headers and trees in one native call; the oracle decodes what it does not take, or raises
        h = native.huffman_read_headers(data, starts, sizes, int(starts[0]) if B else 0)
        for b in np.nonzero(~h.taken)[0].tolist():
            host[b] = hf.decompress_block(data[int(starts[b]) : int(starts[b] + sizes[b])])
    pads, pstart, blens, tables = h.pads, h.pstart, h.blens, h.tables
    _build.count(host_split, "decode", len(host))
    _build.count(native_headers, "decode", int(h.taken.sum()))
    with record_function("rsnb.dec.rows"):
        capb = max(4, -(-int(blens.max()) // 4) * 4)
        cols = torch.arange(capb, device=dev)[None, :]
        bl = _to(blens, dev)[:, None]
        idx = (_to(pstart, dev)[:, None] + cols).clamp(max=max(flat.numel() - 1, 0))
        prows = torch.where(cols < bl, flat[idx], 0) if flat.numel() else torch.zeros((B, capb), dtype=torch.uint8, device=dev)
        prows = prows.to(torch.uint8).contiguous()
    with record_function("rsnb.dec.huffman"):
        cap = -(-cap_out // 4) * 4
        rows, counts, ok = huffman_rows.decode_rows(prows, _to(pads, dev), _to(blens.astype(np.int32), dev),
                                                    _to(tables, dev), cap)
        with sync("faults"):
            ok = ok.cpu().numpy()
    if not ok.all():
        raise ValueError("huffman: bitstream ends inside a code")
    which = np.nonzero(h.raw)[0]
    if which.size:
        # a byte-coded block's ids back to its bytes
        at = _to(which, dev)
        ids_rows = rows[at].to(torch.int64) % huffman_rows.NSYM
        rows = rows.index_copy(0, at, _to(h.back[which], dev).gather(1, ids_rows))
    with sync("lengths"):
        return rows, counts.cpu().numpy().astype(np.int64), host
