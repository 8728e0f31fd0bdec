"""Huffman rows: the port of raisin_tpu/ops/huffman_pallas.py.

Public functions keep the JAX package's per-block layout:

- :func:`encode_rows` (JAX ``encode_rows_huffman``): block bytes (B, S)
  uint8 and each block's code table -> ``(rows, byte_lens, pads)``, where
  row b holds the block's `.rsn` Huffman payload after the pad byte: the
  codes MSB-first, behind ``pads[b] = (8 - bits % 8) % 8`` zero bits.
  Kernel G (csrc/huffman_encode.cu).
- :func:`decode_rows` (JAX ``decode_rows_huffman``): payload rows, pads,
  byte lengths and the packed child tables -> ``(rows, counts, ok)``: the
  decoded bytes, their count and whether the walk ended at the root.
  Kernel H (csrc/huffman_decode.cu).

Tables. The encoder takes ``codes`` and ``code_lens``, each (B, 128)
int32: symbol s of block b has the ``code_lens[b, s]``-bit code whose bits
are the low bits of ``codes[b, s]`` (first bit most significant), up to
32 bits (the JAX package packs them as 132-entry ``bits | len << 26``
rows). A byte >= 128, or one past its
block's length, has no code and adds no bits. The decoder takes the JAX
package's (B, 64) int32 child tables unchanged: read as 256 bytes
little-endian, byte ``2 * node + bit`` is the child of internal node
``node`` (root 0) on ``bit``; a child >= 128 is the leaf of symbol
``child - 128``.

The wide variants take the Huffman stream's rune alphabet (a tree's leaves
as rune ids, an id being the rune's rank in ascending rune order, which is
the header's order), one table for all rows:

- :func:`encode_rows_wide`: (B, S) int32 ids and a (K,) table of codes and
  code lengths -> the same ``(rows, byte_lens, pads)``. An id outside
  0..K-1, or one past its row's length, has no code. Kernel G, wide.
- :func:`decode_rows_wide`: payload rows, pads, byte lengths and a
  (2 * (K - 1),) int32 child table -> ``(rows, counts, ok)`` with int32
  ids in the rows: entry ``2 * node + bit`` is the child of internal node
  ``node`` (root 0, preorder) on ``bit``, ``LEAF | id`` for a leaf. The
  caller maps the ids to runes and those to UTF-8 (``ops/runes.py``).
  Kernel H, wide.

Each wrapper dispatches on the device of the tensor it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
PyTorch version beside it. Each wrapper counts its kernel launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from raisin_tpu_torch.ops import _build
from raisin_tpu_torch.ops.arithmetic_rows import _check_cuda

NSYM = 128  # ASCII symbols; the container sends other blocks to the host oracle
MAX_CODE_BITS = 32
NTAB = 64  # child-table words: 127 internal nodes x 2 children, one byte each
TILE = 4096  # kernel G's symbols a tile (csrc/huffman_encode.cu, which holds the same number)
# kernel H's subsequences (csrc/huffman_decode.cu, which holds the same numbers)
SUB_BITS = 1024  # bits a subsequence, one thread's
SPAN_SUBS = 256  # subsequences a CTA
# the wide tables (csrc/huffman_encode.cu and csrc/huffman_decode.cu hold the same numbers)
LEAF = 1 << 31  # a wide child that is a leaf: LEAF | id
MAX_WIDE = 1 << 24  # ids and internal nodes of a wide table: kernel H's table entry is depth << 24 | id
WIDE_TABLE = 4096  # kernel G holds a wide table of up to this many entries in shared memory, a larger one in L2
LUT_BITS_WIDE = 11  # bits a step of wide kernel H peeks: its table has 2**LUT_BITS_WIDE entries


# ---------------------------------------------------------------------------
# Encode


def _code_of(x: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor, code_lens: torch.Tensor):
    """Each position's (code, length), int64; length 0 past the block and for bytes >= 128."""
    B, S = x.shape
    xi = x.to(torch.int64)
    pos = torch.arange(S, device=x.device)
    has = (pos[None, :] < lengths.to(torch.int64)[:, None]) & (xi < NSYM)
    idx = xi.clamp(max=NSYM - 1)
    L = torch.where(has, code_lens.to(torch.int64).gather(1, idx), 0)
    C = codes.to(torch.int64).gather(1, idx) & 0xFFFFFFFF
    return C, L


def _encode_rows_torch(x, lengths, codes, code_lens, capw: int):
    """Plain version of kernel G: (rows (B, 4 * capw) uint8, byte_lens (B,), pads (B,)), int32."""
    return _pack_codes(*_code_of(x, lengths, codes, code_lens), capw)


def _pack_codes(C: torch.Tensor, L: torch.Tensor, capw: int):
    """Each position's code C and length L, (B, S) int64 -> (rows, byte_lens, pads) as kernel G writes them.

    Every code's bit offset is the pad plus the cumulative sum of the
    code lengths before it; bit k of each code is scattered into a bit
    matrix, which is packed MSB-first into bytes.
    """
    B = C.shape[0]
    dev = C.device
    total = L.sum(1)
    pad = (8 - total % 8) % 8
    start = pad[:, None] + L.cumsum(1) - L
    nbits = 32 * capw
    bits = torch.zeros((B, nbits + 1), dtype=torch.uint8, device=dev)  # column nbits: a dump slot
    for k in range(MAX_CODE_BITS):
        live = k < L
        if not bool(live.any()):
            break
        bit = (C >> (L - 1 - k).clamp(min=0)) & 1
        at = torch.where(live, (start + k).clamp(max=nbits), nbits)
        bits.scatter_(1, at, torch.where(live, bit, 0).to(torch.uint8))
    w8 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    rows = (bits[:, :nbits].reshape(B, 4 * capw, 8).to(torch.int32) * w8).sum(-1).to(torch.uint8)
    return rows, ((total + pad) // 8).to(torch.int32), pad.to(torch.int32)


def tiles(S: int) -> int:
    """Kernel G's tiles a row of S symbols (at least one, so that every block writes its lengths)."""
    return max(1, -(-S // TILE))


def bit_totals(x: torch.Tensor, lengths: torch.Tensor, code_lens: torch.Tensor) -> torch.Tensor:
    """Each block's payload bits, (B,) int64: one gather of the code lengths and a sum."""
    xi = x.to(torch.int64)
    live = (torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(torch.int64)[:, None]) & (xi < NSYM)
    L = code_lens.clamp(0, MAX_CODE_BITS).to(torch.int64).gather(1, xi.clamp(max=NSYM - 1))
    return torch.where(live, L, 0).sum(1)


def _check_totals(got: torch.Tensor, bits: torch.Tensor) -> None:
    """Raise where the encode's own bit totals differ from the caller's."""
    wrong = torch.nonzero(got != bits.to(got.device, torch.int64))
    if wrong.numel():
        b = int(wrong[0, 0])
        raise RuntimeError(f"huffman encode_rows: block {b} codes to {int(got[b])} bits, the caller gave {int(bits[b])}")


def encode_rows(x: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor, code_lens: torch.Tensor, capw: int,
                bits: torch.Tensor | None = None):
    """Huffman encode of B blocks into `.rsn` payload rows (kernel G, or its plain version).

    Args:
      x: (B, S) uint8 block bytes (what lies past ``lengths`` is ignored).
      lengths: (B,) int32.
      codes, code_lens: (B, 128) int32 code tables (module docstring).
      capw: row capacity in 32-bit words.
      bits: (B,) int64, each block's payload bits (the sum of its code
        lengths), which place every code behind its pad; None computes them
        with :func:`bit_totals` on the tensors' device.

    Returns (rows (B, 4 * capw) uint8, byte_lens (B,) int32, pads (B,)
    int32): row b's first ``byte_lens[b]`` bytes are the block's payload
    after the pad byte. A payload longer than the row is cut at the row's
    end while ``byte_lens`` keeps its full length, so callers size
    ``capw`` from the exact bit count and compare. Raises RuntimeError
    where the encode's own bit total differs from ``bits``.
    """
    if x.device.type == "cpu":
        out = _encode_rows_torch(x, lengths, codes, code_lens, capw)
        if bits is not None:
            _check_totals(bit_totals(x, lengths, code_lens), bits)
        return out
    B, S = _check_cuda("huffman encode_rows", x, torch.uint8, 2)
    _check_cuda("huffman encode_rows", lengths, torch.int32, 1, (B,), x.device)
    for t in (codes, code_lens):
        _check_cuda("huffman encode_rows", t, torch.int32, 2, (B, NSYM), x.device)
    dev = x.device
    if bits is None:
        bits = bit_totals(x, lengths, code_lens)
    _check_cuda("huffman encode_rows", bits, torch.int64, 1, (B,), dev)
    return _encode_on_card("rsn_huffman_encode", encode_rows, x, lengths, codes, code_lens, bits, capw)


encode_rows.launches = 0


def _encode_on_card(entry: str, wrapper, x, lengths, codes, code_lens, bits, capw: int, *extra):
    """Kernel G's launch through the library's ``entry`` (``extra`` after ``capw``), counted on ``wrapper``."""
    B, S = x.shape
    dev = x.device
    n_tiles = B * tiles(S)
    if n_tiles >= 2**31:
        raise ValueError(f"huffman {wrapper.__name__}: too many tiles for the kernel")
    # one zeroed buffer (a fill launch a call): the rows, then a status word a tile and a word of two
    # counts, the ticket (low half) and the blocks whose totals differ from bits (high half)
    row_words = -(-B * capw // 2)
    zeroed = torch.zeros(row_words + n_tiles + 1, dtype=torch.int64, device=dev)
    rows = zeroed.view(torch.uint8)[: 4 * B * capw].view(B, 4 * capw)
    work = zeroed[row_words:]
    # the kernel writes every block's totals, byte_lens and pads
    out = torch.empty(2 * B, dtype=torch.int64, device=dev)
    totals, lens = out[:B], out[B:].view(torch.int32)
    byte_lens, pads = lens[:B], lens[B:]
    if B == 0:
        return rows, byte_lens, pads
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(wrapper)
        rc = getattr(lib, entry)(
            x.data_ptr(), lengths.data_ptr(), codes.data_ptr(), code_lens.data_ptr(), bits.data_ptr(),
            rows.data_ptr(), byte_lens.data_ptr(), pads.data_ptr(), totals.data_ptr(), work.data_ptr(), B, S, capw,
            *extra, _build.stream_handle(dev),
        )
    _build.check(entry, rc)
    if int(work[-1]) >> 32:
        _check_totals(totals, bits)
    return rows, byte_lens, pads


def _wide_code_of(ids: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor, code_lens: torch.Tensor):
    """Each position's (code, length), int64, from one (K,) table; length 0 past the row and for ids outside 0..K-1."""
    S = ids.shape[1]
    K = codes.numel()
    pos = torch.arange(S, device=ids.device)
    has = (pos[None, :] < lengths.to(torch.int64)[:, None]) & (ids >= 0) & (ids < K)
    idx = torch.where(has, ids, 0).to(torch.int64)
    if K == 0:
        zero = torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)
        return zero, zero
    L = torch.where(has, code_lens.to(torch.int64).clamp(0, MAX_CODE_BITS)[idx], 0)
    C = codes.to(torch.int64)[idx] & 0xFFFFFFFF
    return C, L


def _encode_rows_wide_torch(ids, lengths, codes, code_lens, capw: int):
    """Plain version of wide kernel G: (rows (B, 4 * capw) uint8, byte_lens (B,), pads (B,)), int32."""
    return _pack_codes(*_wide_code_of(ids, lengths, codes, code_lens), capw)


def encode_rows_wide(ids: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor, code_lens: torch.Tensor,
                     capw: int, bits: torch.Tensor | None = None):
    """Huffman encode of B rows of rune ids into `.rsn` payload rows (wide kernel G, or its plain version).

    Args:
      ids: (B, S) int32 symbol ids (what lies past ``lengths`` is ignored).
      lengths: (B,) int32.
      codes, code_lens: (K,) int32, id i's ``code_lens[i]``-bit code in the
        low bits of ``codes[i]`` (first bit most significant), up to 32 bits.
      capw: row capacity in 32-bit words.
      bits: (B,) int64, each row's payload bits; None sums the code lengths.

    Returns what :func:`encode_rows` returns, and raises where it raises.
    """
    if ids.device.type == "cpu":
        out = _encode_rows_wide_torch(ids, lengths, codes, code_lens, capw)
        if bits is not None:
            _check_totals(_wide_code_of(ids, lengths, codes, code_lens)[1].sum(1), bits)
        return out
    B, S = _check_cuda("huffman encode_rows_wide", ids, torch.int32, 2)
    dev = ids.device
    _check_cuda("huffman encode_rows_wide", lengths, torch.int32, 1, (B,), dev)
    (K,) = _check_cuda("huffman encode_rows_wide", codes, torch.int32, 1)
    _check_cuda("huffman encode_rows_wide", code_lens, torch.int32, 1, (K,), dev)
    if bits is None:
        bits = _wide_code_of(ids, lengths, codes, code_lens)[1].sum(1)
    _check_cuda("huffman encode_rows_wide", bits, torch.int64, 1, (B,), dev)
    return _encode_on_card("rsn_huffman_encode_wide", encode_rows_wide, ids, lengths, codes, code_lens, bits, capw, K)


encode_rows_wide.launches = 0


# ---------------------------------------------------------------------------
# Decode


def _child_bytes(tables: torch.Tensor) -> torch.Tensor:
    """(B, 64) int32 child tables -> (B, 256) int64: entry 2 * node + bit."""
    t = tables.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(4, device=tables.device) * 8
    return ((t[:, :, None] >> sh) & 0xFF).reshape(tables.shape[0], 4 * NTAB)


def _payload_bits(payload_rows, pads, byte_lens):
    """Each row's payload bits after its pad: (bits (B, NB + 1) int64, nbits (B,), positions t (NB + 1,))."""
    B, capb = payload_rows.shape
    dev = payload_rows.device
    pad = pads.to(torch.int64)
    nbits = (8 * byte_lens.to(torch.int64).clamp(0, capb) - pad).clamp(min=0)
    NB = int(nbits.max()) if B else 0
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    raw = ((payload_rows[:, :, None] >> shifts) & 1).reshape(B, 8 * capb)
    t = torch.arange(NB + 1, dtype=torch.int64, device=dev)
    src = (pad[:, None] + t[None, :]).clamp(max=max(8 * capb - 1, 0))
    bits = raw.gather(1, src).to(torch.int64) if capb else torch.zeros((B, NB + 1), dtype=torch.int64, device=dev)
    return bits, nbits, t


def _walk(bits, nbits, t, child_of, depth: int):
    """The code starting at each bit position: (symbol, length), int64; length 0 where none ends inside.

    ``child_of(node, bit)`` -> (child, is_leaf, symbol) steps the tree; a walk
    takes at most ``depth`` bits."""
    NB = bits.shape[1] - 1
    node = torch.zeros_like(bits)
    sym = torch.zeros_like(node)
    length = torch.zeros_like(node)
    walking = t[None, :] < nbits[:, None]
    for k in range(depth):
        if not bool(walking.any()):
            break
        at = (t[None, :] + k).expand(bits.shape[0], -1)
        ok_bit = at < nbits[:, None]
        ch, is_leaf, s = child_of(node, bits.gather(1, at.clamp(max=NB)))
        step = walking & ok_bit
        leaf = step & is_leaf
        sym = torch.where(leaf, s, sym)
        length = torch.where(leaf, k + 1, length)
        node = torch.where(step & ~leaf, ch, node)
        walking = step & ~leaf
    return sym, length


def _emit(sym, length, nbits, t, cap_out: int, dtype):
    """The codes reached from bit 0, in order: (rows (B, cap_out) of ``dtype``, counts (B,), ok (B,)), int32.

    Pointer doubling over ``p -> p + length`` marks the code starts reached
    from bit 0; the symbols at those starts, in order, are the output."""
    B = sym.shape[0]
    NB = sym.shape[1] - 1
    dev = sym.device
    complete = (t[None, :] < nbits[:, None]) & (length > 0)
    term = NB + 1  # the state past a code that runs off the end
    f = torch.full((B, NB + 2), term, dtype=torch.int64, device=dev)
    f[:, : NB + 1] = torch.where(complete, t[None, :] + length, torch.where(t[None, :] == nbits[:, None], t[None, :], term))
    mark = torch.zeros((B, NB + 2), dtype=torch.int32, device=dev)
    mark[:, 0] = 1
    for _ in range(max(1, (NB + 2).bit_length())):
        mark.scatter_reduce_(1, f, mark.clone(), reduce="amax")
        f = f.gather(1, f)
    reached = mark[:, : NB + 1].bool()
    emit = reached & complete
    ok = reached.gather(1, nbits[:, None])[:, 0]
    counts = emit.sum(1)
    rank = emit.to(torch.int64).cumsum(1) - 1
    rows = torch.zeros((B, cap_out + 1), dtype=dtype, device=dev)  # column cap_out: a dump slot
    at = torch.where(emit & (rank < cap_out), rank, cap_out)
    rows.scatter_(1, at, torch.where(emit, sym, 0).to(dtype))
    return rows[:, :cap_out].contiguous(), counts.to(torch.int32), ok.to(torch.int32)


def _decode_rows_torch(payload_rows, pads, byte_lens, tables, cap_out: int):
    """Plain version of kernel H: (rows (B, cap_out) uint8, counts (B,), ok (B,)), int32.

    From every bit position at once, a walk of at most 127 gathers finds
    the code that starts there (its symbol and length); the codes reached
    from bit 0 are the output (:func:`_emit`).
    """
    bits, nbits, t = _payload_bits(payload_rows, pads, byte_lens)
    child = _child_bytes(tables)

    def child_of(node, b):
        ch = child.gather(1, 2 * node + b)
        return ch, ch >= NSYM, ch - NSYM

    sym, length = _walk(bits, nbits, t, child_of, NSYM)  # 128 leaves: no code is longer than 127 bits
    return _emit(sym, length, nbits, t, cap_out, torch.uint8)


def _decode_rows_wide_torch(payload_rows, pads, byte_lens, children, cap_out: int):
    """Plain version of wide kernel H: (rows (B, cap_out) int32 ids, counts (B,), ok (B,)), int32.

    The walk from each bit position loops over code depth (at most
    MAX_CODE_BITS), each step one gather from the (2 * (K - 1),) child table.
    """
    bits, nbits, t = _payload_bits(payload_rows, pads, byte_lens)
    child = children.to(torch.int64) & 0xFFFFFFFF

    def child_of(node, b):
        ch = child[2 * node + b]
        return ch, ch >= LEAF, ch - LEAF

    sym, length = _walk(bits, nbits, t, child_of, MAX_CODE_BITS)
    return _emit(sym, length, nbits, t, cap_out, torch.int32)


def workspace_bytes(B: int, capb: int) -> int:
    """Kernel H's workspace for B rows of capb bytes: 16 bytes for each of its subsequences."""
    subs = -(-8 * capb // SUB_BITS)
    spans = max(1, -(-subs // SPAN_SUBS))
    return 16 * B * spans * SPAN_SUBS


def decode_rows(payload_rows: torch.Tensor, pads: torch.Tensor, byte_lens: torch.Tensor, tables: torch.Tensor,
                cap_out: int):
    """Huffman decode of B payload rows (kernel H, or its plain version).

    Args:
      payload_rows: (B, capb) uint8; row b's first ``byte_lens[b]`` bytes are
        the payload after the pad byte; capb % 4 == 0.
      pads: (B,) int32 leading pad bits to skip.
      byte_lens: (B,) int32.
      tables: (B, 64) int32 packed child tables (module docstring).
      cap_out: output bytes per row, a multiple of 4.

    Returns (rows (B, cap_out) uint8, counts (B,) int32, ok (B,) int32):
    ``counts[b]`` counts every decoded symbol, also those past ``cap_out``
    that the row cannot hold; ``ok[b]`` is 1 when the walk ended at the
    root (the stream ends on a code boundary).
    """
    if cap_out % 4 or cap_out < 0:
        raise ValueError("cap_out must be a non-negative multiple of 4")
    if payload_rows.device.type == "cpu":
        return _decode_rows_torch(payload_rows, pads, byte_lens, tables, cap_out)
    B, capb = _check_cuda("huffman decode_rows", payload_rows, torch.uint8, 2)
    if capb % 4:
        raise ValueError("huffman decode_rows: payload rows must hold a multiple of 4 bytes")
    for t in (pads, byte_lens):
        _check_cuda("huffman decode_rows", t, torch.int32, 1, (B,), payload_rows.device)
    _check_cuda("huffman decode_rows", tables, torch.int32, 2, (B, NTAB), payload_rows.device)
    dev = payload_rows.device
    rows = torch.zeros((B, cap_out), dtype=torch.uint8, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    ok = torch.ones(B, dtype=torch.int32, device=dev)
    if B == 0:
        return rows, counts, ok
    work = torch.empty(workspace_bytes(B, capb) // 8, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(decode_rows)
        rc = lib.rsn_huffman_decode(
            payload_rows.data_ptr(), pads.data_ptr(), byte_lens.data_ptr(), tables.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), ok.data_ptr(), work.data_ptr(), B, capb, cap_out,
            _build.stream_handle(dev),
        )
    _build.check("rsn_huffman_decode", rc)
    return rows, counts, ok


decode_rows.launches = 0


def decode_rows_wide(payload_rows: torch.Tensor, pads: torch.Tensor, byte_lens: torch.Tensor, children: torch.Tensor,
                     lattice: int, cap_out: int):
    """Huffman decode of B payload rows into rune ids (wide kernel H, or its plain version).

    Args:
      payload_rows, pads, byte_lens: as :func:`decode_rows`.
      children: (2 * (K - 1),) int32 child table of the rows' one tree
        (module docstring), K >= 2; ``K - 1`` and every id under MAX_WIDE.
      lattice: a number that divides every code length (their greatest
        common divisor; 1 always does). The kernel starts its speculative
        walks on its multiples; the plain version does not need it.
      cap_out: ids a row holds.

    Returns (rows (B, cap_out) int32, counts (B,) int32, ok (B,) int32),
    with the meaning of :func:`decode_rows`'s.
    """
    if cap_out < 0 or lattice < 1:
        raise ValueError("huffman decode_rows_wide: cap_out must be >= 0 and lattice >= 1")
    if payload_rows.device.type == "cpu":
        return _decode_rows_wide_torch(payload_rows, pads, byte_lens, children, cap_out)
    B, capb = _check_cuda("huffman decode_rows_wide", payload_rows, torch.uint8, 2)
    if capb % 4:
        raise ValueError("huffman decode_rows_wide: payload rows must hold a multiple of 4 bytes")
    dev = payload_rows.device
    for t in (pads, byte_lens):
        _check_cuda("huffman decode_rows_wide", t, torch.int32, 1, (B,), dev)
    (n_children,) = _check_cuda("huffman decode_rows_wide", children, torch.int32, 1)
    if n_children < 2 or n_children % 2 or n_children // 2 >= MAX_WIDE:
        raise ValueError(f"huffman decode_rows_wide: a child table of {n_children} entries")
    rows = torch.zeros((B, cap_out), dtype=torch.int32, device=dev)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    ok = torch.ones(B, dtype=torch.int32, device=dev)
    if B == 0:
        return rows, counts, ok
    work = torch.empty(workspace_bytes(B, capb) // 8 + (1 << LUT_BITS_WIDE) // 2, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(decode_rows_wide)
        rc = lib.rsn_huffman_decode_wide(
            payload_rows.data_ptr(), pads.data_ptr(), byte_lens.data_ptr(), children.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), ok.data_ptr(), work.data_ptr(), B, capb, cap_out, lattice,
            _build.stream_handle(dev),
        )
    _build.check("rsn_huffman_decode_wide", rc)
    return rows, counts, ok


decode_rows_wide.launches = 0
