"""Block-parallel Huffman for the RSNB container: the port of raisin_tpu/ops/huffman_blocks.py.

The split of labour is the JAX package's: the per-block tree is built on
the host from the block's symbol counts, and the work over every byte runs
on the card, all blocks of a batch in one launch: kernel G
(:func:`huffman_rows.encode_rows`) writes the payloads, kernel H
(:func:`huffman_rows.decode_rows`) walks them back. The trees of a batch
come from one call into the native runtime (``native.huffman_trees``: Go's
container/heap mechanics in C, the trees of ``formats/huffman.build_tree``),
which runs without the interpreter lock, so that two callers' trees do not
wait for each other.

- Encode (:func:`encode_blocks`): one ``scatter_add_`` into a (B, 256)
  table counts every block's symbols on the card (faster on an H100 than a
  ``torch.bincount`` over ``block * 256 + byte``, whose bins contend more);
  one copy brings the table to the host. From it the host builds every
  block's tree and code table, exact bit count (so rows are sized exactly)
  and header. The headers come back to the card as one buffer, and each
  block's payload (header, separator, pad byte, bits) is framed there.
- Decode (:func:`decode_blocks`): the host parses each block's header, then
  builds every block's tree and packed child table; the payload rows are
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
runs inside an ``ops/device.sync`` range. ``trees`` counts the blocks whose
tree the host built, per direction.
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
# blocks whose tree the host built since the last reset, per direction
trees = {"encode": 0, "decode": 0}


def reset_host_split() -> None:
    host_split["encode"] = host_split["decode"] = 0


def reset_trees() -> None:
    trees["encode"] = trees["decode"] = 0


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: from pageable memory, a copy that waits for the card's queue."""
    with sync("h2d"):
        return torch.from_numpy(a).to(dev)


def _right_aligned(pieces: list[bytes], width: int) -> np.ndarray:
    """(len(pieces), width) uint8 matrix, each piece ending at the last column."""
    lens = np.array([len(p) for p in pieces], dtype=np.int64)
    out = np.zeros((len(pieces), width), dtype=np.uint8)
    flat = np.frombuffer(b"".join(pieces), dtype=np.uint8)
    if flat.size:
        row = np.repeat(np.arange(len(pieces)), lens)
        within = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        out[row, width - lens[row] + within] = flat
    return out


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


def code_tables(counts: np.ndarray, raw: np.ndarray | None = None):
    """Each card block's code table and header, built on the host from its counts.

    ``raw`` marks the blocks coded over their bytes; the others are ASCII or
    take the oracle. The trees come from ``native.huffman_trees``, Go's, all
    blocks in one call. Returns (codes (B, 128) uint32, code_lens (B, 128)
    int32, prefixes, on_host (B,) bool): ``prefixes[b]`` is the block's
    header and separator, empty for the blocks the oracle codes
    (``on_host``: a byte >= 0x80 in a block not in ``raw``, or a byte-coded
    block with no :func:`ascii_ids`), whose tables stay zero. A byte-coded
    card block's codes lie at its bytes' :func:`ascii_ids`.
    """
    B = len(counts)
    raw = np.zeros(B, dtype=bool) if raw is None else raw
    on_host = counts[:, huffman_rows.NSYM :].any(1) & ~raw
    ids = np.tile(np.arange(256, dtype=np.uint8), (B, 1))
    for b in np.nonzero(raw)[0].tolist():
        at = ascii_ids(np.nonzero(counts[b])[0].tolist())
        if at is None:
            on_host[b] = True
        else:
            ids[b] = at
    card = np.where(on_host[:, None], 0, counts)
    codes256, lens256, _, longest = native.huffman_trees(card, ids)
    if (longest > huffman_rows.CONTAINER_CODE_BITS).any():
        raise ValueError(f"huffman: code length beyond {huffman_rows.CONTAINER_CODE_BITS} bits")
    codes = np.zeros((B, huffman_rows.NSYM), dtype=np.uint32)
    code_lens = np.zeros((B, huffman_rows.NSYM), dtype=np.int32)
    rows, syms = np.nonzero(card)
    codes[rows, ids[rows, syms]] = codes256[rows, syms]
    code_lens[rows, ids[rows, syms]] = lens256[rows, syms]
    prefixes: list[bytes] = []
    for b in range(B):
        if on_host[b]:
            prefixes.append(b"")
            continue
        present = np.nonzero(counts[b])[0]
        freqs = dict(zip(present.tolist(), counts[b, present].tolist()))
        prefixes.append(hf.build_header(freqs, raw=bool(raw[b])) + hf.SEPARATOR)
    return codes, code_lens, prefixes, on_host


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
        codes, code_lens, prefixes, on_host = code_tables(counts, raw)
        ids = {b: ascii_ids(np.nonzero(counts[b])[0].tolist()) for b in np.nonzero(raw & ~on_host)[0].tolist()}
    _build.count(trees, "encode", B)  # a host block's tree is built inside the oracle
    host = np.nonzero(on_host)[0]
    if host.size:
        _build.count(host_split, "encode", int(host.size))
        read.update(_rows(x, host[~np.isin(host, list(read))]))
        for b in host.tolist():
            prefixes[b] = hf.compress_block(read[b][: n[b]].tobytes())
    nbits = (counts[:, : huffman_rows.NSYM] * code_lens).sum(1)  # 0 for the host blocks, whose tables are zero
    for b, at in ids.items():
        nbits[b] = (counts[b] * code_lens[b, at]).sum()
    want = (nbits + 7) // 8
    with record_function("rsnb.enc.huffman"):
        if ids:
            # the byte-coded blocks' bytes as their ids
            which = np.array(sorted(ids))
            at = _to(which, dev)
            x = x.index_copy(0, at, _to(np.stack([ids[b] for b in which]), dev).gather(1, x[at].to(torch.int64)))
        # kernel G places the codes behind the pad of these totals and raises where its own differ
        rows, _, pads = huffman_rows.encode_rows(
            x, lengths, _to(codes.view(np.int32), dev), _to(code_lens, dev),
            max(1, int(want.max() + 3) // 4), bits=_to(nbits, dev),
        )
    with record_function("rsnb.enc.hframe"):
        # row b: [prefix, right-aligned][pad byte][payload]; host blocks keep their prefix only
        pre_lens = np.array([len(p) for p in prefixes], dtype=np.int64)
        P = int(pre_lens.max())
        tail = np.where(on_host, 0, 1 + want)
        framed = torch.cat([_to(_right_aligned(prefixes, P), dev), pads.to(torch.uint8)[:, None], rows], dim=1)
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
    pstart = np.zeros(B, dtype=np.int64)  # payload bits start, relative to flat
    blens = np.zeros(B, dtype=np.int64)
    pads = np.zeros(B, dtype=np.int32)
    host: dict[int, bytes] = {}
    back: dict[int, np.ndarray] = {}  # a byte-coded block's bytes by id
    freqs_of = np.zeros((B, 256), dtype=np.int64)  # the card blocks' headers
    ids = np.tile(np.arange(256, dtype=np.uint8), (B, 1))
    sep = hf.SEPARATOR
    with record_function("rsnb.dec.tree"):
        for b in range(B):
            lo, hi = int(starts[b]), int(starts[b] + sizes[b])
            cut = data.find(sep, lo, hi)
            freqs, byte_coded, at = None, False, None
            if cut >= 0 and cut + len(sep) < hi:
                try:
                    freqs, byte_coded = hf.read_header(data[lo:cut])
                except ValueError:
                    freqs = None
                if byte_coded and freqs:
                    at = ascii_ids(freqs)
            # the card takes a tree of two leaves or more, each an ASCII symbol or a byte with an id,
            # each counted once or more (a count of 0 leaves the card's trees)
            if (not freqs or len(freqs) < 2 or min(freqs.values()) < 1
                    or (at is None and max(freqs) >= huffman_rows.NSYM)):
                # what the card does not take: the oracle decodes it or raises
                host[b] = hf.decompress_block(data[lo:hi])
                continue
            freqs_of[b, list(freqs)] = list(freqs.values())
            if at is not None:
                ids[b] = at
                back[b] = np.zeros(huffman_rows.NSYM, dtype=np.uint8)
                back[b][at[list(freqs)]] = list(freqs)
            pads[b] = data[cut + len(sep)]
            pstart[b] = cut + len(sep) + 1 - starts[0]
            blens[b] = hi - (cut + len(sep) + 1)
        tables = native.huffman_trees(freqs_of, ids)[2]
    _build.count(trees, "decode", B)  # a host block's tree is built inside the oracle
    _build.count(host_split, "decode", len(host))
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
    if back:
        which = np.array(sorted(back))
        at = _to(which, dev)
        ids_rows = rows[at].to(torch.int64) % huffman_rows.NSYM
        rows = rows.index_copy(0, at, _to(np.stack([back[b] for b in which]), dev).gather(1, ids_rows))
    with sync("lengths"):
        return rows, counts.cpu().numpy().astype(np.int64), host
