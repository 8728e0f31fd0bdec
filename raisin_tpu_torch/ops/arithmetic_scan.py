"""Single-stream adaptive arithmetic codec on the card: the port of raisin_tpu/ops/arithmetic_scan.py.

The ``device`` backend of ``arithmetic`` (registered in
``engine/registry.py``):

- :func:`compress` (JAX :435): kernel I
  (:func:`arithmetic_rows.encode_events`, the port of
  ``arithmetic_pallas._enc_kernel``) writes the event record of each of
  the S = n + 1 coder steps, then :func:`expand_events` (JAX
  ``_expand_block_bits`` :176) turns the records into the sentinel-
  prepadded `.rsn` bits. Kernel I takes the place of the XLA scan
  ``_events_xla`` (:114) that the JAX stream path runs; the JAX package
  reaches ``_enc_kernel`` only with ``use_pallas=True``. It also rounds S
  up to a power of two (``_bucket`` :422) to limit jit recompiles;
  PyTorch runs eagerly and kernel I takes any S.
- :func:`decompress` (JAX :449): the port's copy of the host oracle, as in
  the JAX package: a raw stream does not carry its length, which kernel C
  needs.
- :func:`encode_blocks` (JAX :142) with its ``max_bits``, and
  :func:`decompress`'s ``out_len`` (kernel C at B = 1), keep the JAX
  package's API; no caller in the port uses them.

The expansion is plain PyTorch on the device the records lie on, as it is
XLA and not Pallas in the JAX package. A step's bits are its emissions in
slot order, each followed by the pending bits it flushes (the complement
of the emitted bit): the carried count ``slot0`` after the first, the
in-step count of the slot after the others. A cumulative sum of the steps'
bit counts, (B, S) int64, places every step; output bits are then made in
pieces of :data:`EXPAND_PIECE` over all blocks, each finding its step by a
batched ``searchsorted`` and its slot among the step's 16, so that no
index tensor grows with the 16 or 17 bits a step can write (a 64 MiB
stream would need ~9 GB of int64 indices at once).

``encode_blocks_packed`` and ``decode_blocks_packed`` are not ported
(ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from raisin_tpu_torch.formats import arithmetic
from raisin_tpu_torch.ops import arithmetic_rows
from raisin_tpu_torch.ops.device import d2h, h2d, resolve_device

EOF = arithmetic_rows.EOF
SLOTS = arithmetic_rows.EVENT_SLOTS
# Upper bound on the bits a coded symbol writes: <= 16 emissions plus
# pending flushes; a block's stream holds <= 17 * steps + slack bits.
BITS_PER_STEP_BOUND = 17
EXPAND_PIECE = 1 << 20  # output bits, over all blocks, expanded at once


def _slot_bits(rec: torch.Tensor, carried: torch.Tensor) -> torch.Tensor:
    """Bits each event slot writes: (..., 16) int32 from records (..., 16) and carried counts (...).

    An emitting slot writes its bit and the pending bits it flushes: the
    carried count if it is its step's first emission, else its own count.
    """
    r = rec.to(torch.int32)
    valid = r >> 7
    first = (r >> 5) & valid
    return valid * (1 + (r & 0x1F)) + first * carried[..., None]


def _layout(slots: torch.Tensor, slot0: torch.Tensor):
    """-> (lens, ends, total, pad): each step's bits and their inclusive
    cumulative ends (B, S) int64, each block's stream bits and its
    ``.rsn`` prepad of 1..8 bits (bits.go:48), (B,) int64."""
    B, S, _ = slots.shape
    lens = torch.empty((B, S), dtype=torch.int64, device=slots.device)
    step = max(1, EXPAND_PIECE // max(B, 1))
    for a in range(0, S, step):
        lens[:, a : a + step] = _slot_bits(slots[:, a : a + step], slot0[:, a : a + step]).sum(-1)
    ends = lens.cumsum(1)
    total = ends[:, -1]
    return lens, ends, total, 8 - total % 8


def _bits(slots, slot0, layout, j0: int, j1: int) -> torch.Tensor:
    """Bits [j0, j1) of every block's prepadded stream: (B, j1 - j0) uint8, 0 past its end."""
    lens, ends, total, pad = layout
    B, S, _ = slots.shape
    dev = slots.device
    j = torch.arange(j0, j1, dtype=torch.int64, device=dev)[None, :]
    jj = j - pad[:, None]  # position in the coder's bits; the prepad lies below 0
    # the step that writes bit jj: the first whose end passes it (an empty step never does)
    k = torch.searchsorted(ends, jj.expand(B, -1).contiguous(), right=True).clamp_(max=S - 1)
    w = jj - (ends.gather(1, k) - lens.gather(1, k))  # bit within the step
    flat = torch.arange(B, device=dev)[:, None] * S + k
    rec = slots.view(B * S, SLOTS)[flat]  # (B, P, 16): the step's record
    sb = _slot_bits(rec, slot0.view(B * S)[flat])
    sends = sb.cumsum(-1)
    q = (sends <= w[..., None]).sum(-1, keepdim=True).clamp_(max=SLOTS - 1)  # the slot
    within = w - (sends.gather(-1, q) - sb.gather(-1, q))[..., 0]
    bit = (rec.gather(-1, q)[..., 0] >> 6) & 1
    raw = torch.where(within == 0, bit, 1 - bit)  # the emission, then its flush
    sentinel = (j == pad[:, None] - 1).to(torch.uint8)
    return torch.where(jj < 0, sentinel, torch.where(jj < total[:, None], raw, 0)).to(torch.uint8)


def expand_events(slots: torch.Tensor, slot0: torch.Tensor, max_bits: int | None = None):
    """Event records -> (padded_bits (B, max_bits) uint8, bit_lengths (B,) int32).

    Row b holds block b's sentinel-prepadded `.rsn` bits, one bit a byte,
    zero past ``bit_lengths[b]``, which stays right when the stream is
    longer than ``max_bits``. ``max_bits=None`` takes the longest stream's.
    """
    B = slots.shape[0]
    layout = _layout(slots, slot0)
    if max_bits is None:
        max_bits = int((layout[2] + layout[3]).max()) if B else 0
    out = torch.empty((B, max_bits), dtype=torch.uint8, device=slots.device)
    piece = max(8, EXPAND_PIECE // max(B, 1) // 8 * 8)
    for j0 in range(0, max_bits, piece):
        j1 = min(j0 + piece, max_bits)
        out[:, j0:j1] = _bits(slots, slot0, layout, j0, j1)
    _, _, total, pad = layout
    return out, (total + pad).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8 * m) uint8 bits -> (B, m) uint8 bytes, MSB first."""
    B, nbits = bits.shape
    w8 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    return (bits.view(B, nbits // 8, 8).to(torch.int32) * w8).sum(-1).to(torch.uint8)


def encode_blocks(symbols: torch.Tensor, lengths: torch.Tensor, max_bits: int | None = None):
    """Device encode of B independent blocks (kernel I, then the expansion).

    Args:
      symbols: (B, S) int32 — block bytes with EOF (256) at position
        ``lengths[b]``; entries past that are ignored. S >= 1.
      lengths: (B,) int32 payload length per block (< S).
      max_bits: per-block output-bit capacity, rounded up to a multiple of
        8. Defaults to the worst-case bound ``17 * S + 16``; callers may pass
        a tight capacity and compare ``bit_lengths`` with it, since
        ``bit_lengths`` stays correct when the bits overflow it.

    Returns:
      padded_bits: (B, max_bits) uint8 — the `.rsn` bitstream per block,
        sentinel prepad applied, zero-filled past ``bit_lengths``.
      bit_lengths: (B,) int32 — multiple of 8; compressed bytes = bits/8.
    """
    B, S = symbols.shape
    if S == 0:
        raise ValueError("encode_blocks: symbols need at least one step (the EOF)")
    if max_bits is None:
        max_bits = BITS_PER_STEP_BOUND * S + 16
    max_bits = (max_bits + 7) // 8 * 8
    if symbols.numel():
        lo, hi = torch.aminmax(symbols)
        if int(lo) < 0 or int(hi) > EOF:
            raise ValueError("encode_blocks: symbols must lie in [0, 256]")
    with record_function("stream.enc.events"):
        slots, slot0 = arithmetic_rows.encode_events(symbols, lengths)
    with record_function("stream.enc.expand"):
        return expand_events(slots, slot0, max_bits)


def compress(data: bytes, device: torch.device | str | None = None) -> bytes:
    """Single-stream `.rsn` arithmetic encode on the card (bit-exact)."""
    dev = resolve_device(device)
    n = len(data)
    with record_function("stream.enc.h2d"):
        eof = torch.full((1,), EOF, dtype=torch.int32, device=dev)
        symbols = torch.cat([h2d(data, dev).to(torch.int32), eof])[None]  # EOF at n, S = n + 1
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    with record_function("stream.enc.events"):
        slots, slot0 = arithmetic_rows.encode_events(symbols, lengths)
    with record_function("stream.enc.expand"):
        stream = pack_bits(expand_events(slots, slot0)[0])[0]
    with record_function("stream.enc.d2h"):
        return d2h(stream)


def decompress(data: bytes, out_len: int | None = None, device: torch.device | str | None = None) -> bytes:
    """Single-stream `.rsn` arithmetic decode.

    A raw stream, which carries no length, decodes with the port's copy of
    the host oracle, as in the JAX package. With ``out_len`` (the decoded
    length; the JAX package's API, which no caller in the port uses)
    kernel C decodes on ``device``. Only that path needs a card.
    """
    if out_len is None:
        return arithmetic.decompress(data)
    dev = resolve_device(device)
    # bits.go:63 strips everything through the first 1 bit; without the
    # zero bytes before it, that bit lies in byte 0, where kernel C finds it
    start = next((i for i, b in enumerate(data) if b), None)
    if start is None:
        raise ValueError("couldn't unpack: no sentinel bit found")
    payload = memoryview(data)[start:]
    with record_function("stream.dec.h2d"):
        prow = torch.nn.functional.pad(h2d(payload, dev), (0, 1))[None]  # room for the decoder tail byte
        blens = torch.tensor([len(payload)], dtype=torch.int32, device=dev)
        olens = torch.tensor([out_len], dtype=torch.int32, device=dev)
    with record_function("stream.dec.coder"):
        syms, eof_ok = arithmetic_rows.decode_rows(prow, blens, olens, out_len + 1)
        if not bool(eof_ok[0]):
            raise ValueError("arithmetic(device): EOF symbol not found where expected")
    with record_function("stream.dec.d2h"):
        return d2h(syms[0, :out_len])
