"""Block-parallel Huffman for the RSNB container: the port of raisin_tpu/ops/huffman_blocks.py.

The split of labour is the JAX package's: the per-block tree (Go's
container/heap mechanics, :mod:`raisin_tpu_torch.formats.huffman`) is
built on the host from the block's symbol counts, and the work over every
byte runs on the card, all blocks of a batch in one launch: kernel G
(:func:`huffman_rows.encode_rows`) writes the payloads, kernel H
(:func:`huffman_rows.decode_rows`) walks them back.

- Encode (:func:`encode_blocks`): one ``scatter_add_`` into a (B, 256)
  table counts every block's symbols on the card (faster on an H100 than a
  ``torch.bincount`` over ``block * 256 + byte``, whose bins contend more);
  one copy brings the table to the host. From it the host builds each
  block's tree, code table, exact bit count (so rows are sized exactly)
  and header. The headers come back to the card as one buffer, and each
  block's payload (header, separator, pad byte, bits) is framed there.
- Decode (:func:`decode_blocks`): the host parses each block's header and
  builds its tree and packed child table; the payload rows are cut on the
  card from the container's body; the pad byte gives the start bit.

Blocks with a byte >= 0x80 (trees with a non-ASCII symbol on decode) take
the format's own split, as in the JAX package: Go's rune iteration differs
from byte iteration there (huffman.go:306-310), so the port's copy of the
host oracle codes them whole. ``host_split`` counts them; the bench corpus
has none. Everything else decodes or raises as
``raisin_tpu.ops.huffman_blocks`` does: an empty block raises the oracle's
error, a single-symbol tree (zero-length code) the oracle's "not
decodable", a header the oracle cannot read the oracle's message, and a
walk that does not end at the root "huffman: bitstream ends inside a
code". A single-symbol block encodes on the card (no bits, pad 0), where
the JAX package calls the oracle; the bytes are the same.

Each stage runs in its own ``record_function`` range: ``rsnb.enc.count``,
``rsnb.enc.tree`` (host), ``rsnb.enc.huffman`` (kernel G),
``rsnb.enc.frame``; ``rsnb.dec.tree`` (host), ``rsnb.dec.rows``,
``rsnb.dec.huffman`` (kernel H and its ``ok`` flags).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from raisin_tpu_torch.formats import huffman as hf
from raisin_tpu_torch.ops import huffman_rows

# blocks that took the host oracle since the last reset, per direction
host_split = {"encode": 0, "decode": 0}


def reset_host_split() -> None:
    host_split["encode"] = host_split["decode"] = 0


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


def code_table(tree) -> tuple[list[int], list[int], list[int]]:
    """The tree's (symbols, codes as integers, code lengths), from ``print_codes``."""
    vals, bins = hf.print_codes(tree)
    return vals, [int(c, 2) if c else 0 for c in bins], [len(c) for c in bins]


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


# ---------------------------------------------------------------------------
# Encode


def count_symbols(x: torch.Tensor, lengths: torch.Tensor) -> np.ndarray:
    """(B, 256) int64 counts of every block's bytes: one scatter-add on the device, one copy back."""
    S = x.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < lengths.to(torch.int64)[:, None]
    counts = torch.zeros((x.shape[0], 256), dtype=torch.int32, device=x.device)
    counts.scatter_add_(1, x.to(torch.int64), valid.to(torch.int32))
    return counts.cpu().numpy().astype(np.int64)


def code_tables(counts: np.ndarray, first_block: int = 0):
    """Each ASCII block's code table and header, built on the host from its counts.

    Returns (codes (B, 128) uint32, code_lens (B, 128) int32, prefixes,
    on_host (B,) bool): ``prefixes[b]`` is the block's header and separator,
    empty for the blocks with a byte >= 0x80 (``on_host``), whose tables
    stay zero.
    """
    B = len(counts)
    on_host = counts[:, huffman_rows.NSYM :].any(1)
    codes = np.zeros((B, huffman_rows.NSYM), dtype=np.uint32)
    code_lens = np.zeros((B, huffman_rows.NSYM), dtype=np.int32)
    prefixes: list[bytes] = []
    for b in range(B):
        if on_host[b]:
            prefixes.append(b"")
            continue
        syms = np.nonzero(counts[b])[0]
        freqs = dict(zip(syms.tolist(), counts[b, syms].tolist()))
        vals, cs, ls = code_table(hf.build_tree(freqs))
        if max(ls) > huffman_rows.MAX_CODE_BITS:
            raise ValueError(
                f"huffman: block {first_block + b} needs a {max(ls)}-bit code; codes past "
                f"{huffman_rows.MAX_CODE_BITS} bits come with ROADMAP Queue 1 item 18"
            )
        codes[b, vals] = cs
        code_lens[b, vals] = ls
        prefixes.append(hf.build_header(freqs) + hf.SEPARATOR)
    return codes, code_lens, prefixes, on_host


def encode_blocks(x: torch.Tensor, lengths: torch.Tensor, first_block: int = 0):
    """Exact per-block `.rsn` Huffman payloads of B blocks.

    Args:
      x: (B, S) uint8 block bytes on the device (what lies past ``lengths``
        is ignored).
      lengths: (B,) int32 on the same device.
      first_block: the container index of block 0, for error messages.

    Returns (flat, sizes): every block's payload concatenated in block
    order (uint8, on the device) and each payload's length (np.int64).
    Raises ValueError for an empty block and for a code longer than 32
    bits.
    """
    dev = x.device
    B = x.shape[0]
    with record_function("rsnb.enc.count"):
        counts = count_symbols(x, lengths)
    n = counts.sum(1)
    if (n == 0).any():
        hf.compress(b"")  # raises the oracle's error
    with record_function("rsnb.enc.tree"):
        codes, code_lens, prefixes, on_host = code_tables(counts, first_block)
    host = np.nonzero(on_host)[0]
    if host.size:
        host_split["encode"] += int(host.size)
        rows_np = x[torch.from_numpy(host).to(dev)].cpu().numpy()
        for row, b in zip(rows_np, host.tolist()):
            prefixes[b] = hf.compress(row[: n[b]].tobytes())
    nbits = (counts[:, : huffman_rows.NSYM] * code_lens).sum(1)  # 0 for the host blocks, whose tables are zero
    want = (nbits + 7) // 8
    with record_function("rsnb.enc.huffman"):
        # kernel G places the codes behind the pad of these totals and raises where its own differ
        rows, _, pads = huffman_rows.encode_rows(
            x, lengths, torch.from_numpy(codes.view(np.int32)).to(dev), torch.from_numpy(code_lens).to(dev),
            max(1, int(want.max() + 3) // 4), bits=torch.from_numpy(nbits).to(dev),
        )
    with record_function("rsnb.enc.frame"):
        # row b: [prefix, right-aligned][pad byte][payload]; host blocks keep their prefix only
        pre_lens = np.array([len(p) for p in prefixes], dtype=np.int64)
        P = int(pre_lens.max())
        tail = np.where(on_host, 0, 1 + want)
        framed = torch.cat(
            [torch.from_numpy(_right_aligned(prefixes, P)).to(dev), pads.to(torch.uint8)[:, None], rows], dim=1
        )
        cols = torch.arange(framed.shape[1], device=dev)[None, :]
        lo = torch.from_numpy(P - pre_lens).to(dev)[:, None]
        hi = torch.from_numpy(P + tail).to(dev)[:, None]
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
    tables = np.zeros((B, huffman_rows.NTAB), dtype=np.int32)
    pstart = np.zeros(B, dtype=np.int64)  # payload bits start, relative to flat
    blens = np.zeros(B, dtype=np.int64)
    pads = np.zeros(B, dtype=np.int32)
    host: dict[int, bytes] = {}
    sep = hf.SEPARATOR
    with record_function("rsnb.dec.tree"):
        for b in range(B):
            lo, hi = int(starts[b]), int(starts[b] + sizes[b])
            cut = data.find(sep, lo, hi)
            table = None
            if cut >= 0 and cut + len(sep) < hi:
                try:
                    tree = hf.build_tree(hf.parse_header(data[lo:cut]))
                except ValueError:
                    tree = None
                if tree is not None and not isinstance(tree, hf.Leaf):
                    table = packed_table(tree)
            if table is None:
                # what the card does not take: the oracle decodes it or raises
                host[b] = hf.decompress(data[lo:hi])
                continue
            tables[b] = table
            pads[b] = data[cut + len(sep)]
            pstart[b] = cut + len(sep) + 1 - starts[0]
            blens[b] = hi - (cut + len(sep) + 1)
    host_split["decode"] += len(host)
    with record_function("rsnb.dec.rows"):
        capb = max(4, -(-int(blens.max()) // 4) * 4)
        cols = torch.arange(capb, device=dev)[None, :]
        bl = torch.from_numpy(blens).to(dev)[:, None]
        idx = (torch.from_numpy(pstart).to(dev)[:, None] + cols).clamp(max=max(flat.numel() - 1, 0))
        prows = torch.where(cols < bl, flat[idx], 0) if flat.numel() else torch.zeros((B, capb), dtype=torch.uint8, device=dev)
        prows = prows.to(torch.uint8).contiguous()
    with record_function("rsnb.dec.huffman"):
        cap = -(-cap_out // 4) * 4
        rows, counts, ok = huffman_rows.decode_rows(
            prows,
            torch.from_numpy(pads).to(dev),
            torch.from_numpy(blens.astype(np.int32)).to(dev),
            torch.from_numpy(tables).to(dev),
            cap,
        )
        ok = ok.cpu().numpy()
    if not ok.all():
        raise ValueError("huffman: bitstream ends inside a code")
    return rows, counts.cpu().numpy().astype(np.int64), host
