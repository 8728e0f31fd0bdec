"""The LZSS escape layer on tensors, both directions, for a whole batch.

The counterpart of raisin_tpu/formats/lzss_ref.py:encode_opening_symbols
and decode_opening_symbols_np, of the container's escape handling in
raisin_tpu/parallel/blocks.py (``_escape_clean``, ``_escaped_blocks``,
the device byte map of ops/pipeline_jax.py:lzss_tokens_words) and of the
escape decode in ``_dec_tail``. The rules (reference lzss.go:369,391):

- encode: ``<`` (0x3C) becomes 0xFF, 0xFF becomes ``5C FF`` and 0x5C
  becomes ``5C 5C``;
- decode: a byte is escaped when the run of 0x5C just before it has odd
  length; an unescaped 0x5C is dropped and an unescaped 0xFF becomes ``<``.

These are plain PyTorch ops on the device the tensors lie on: the JAX
package runs them in numpy or XLA, outside any Pallas kernel. When no
byte of the batch is 0x5C or 0xFF (escape-clean input), encoding is a byte
map and lengths do not change; otherwise a cumulative sum gives every
byte's output offset, and a block can grow to twice its length.
"""

from __future__ import annotations

import torch

OPENING = 0x3C  # '<'
ENCODED_OPENING = 0xFF
ESCAPE = 0x5C


def _valid(shape, lengths: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(shape[1], device=lengths.device)
    return cols[None, :] < lengths[:, None]


def escape_blocks(x: torch.Tensor, lengths: torch.Tensor):
    """Escape B blocks at once.

    Args:
      x: (B, W) uint8 block bytes (what lies past ``lengths`` is ignored).
      lengths: (B,) int32.

    Returns (xe (B, S) uint8, elen (B,) int32): each block's escaped bytes,
    zero past ``elen``; S = W for escape-clean batches, else max(elen).
    """
    valid = _valid(x.shape, lengths)
    mapped = torch.where(x == OPENING, ENCODED_OPENING, x)
    grows = ((x == ENCODED_OPENING) | (x == ESCAPE)) & valid
    if not bool(grows.any()):
        return torch.where(valid, mapped, 0).contiguous(), lengths
    B, W = x.shape
    extra = grows.to(torch.int32)
    elen = (lengths + extra.sum(1, dtype=torch.int32)).to(torch.int32)
    S = int(elen.max())
    # output offset of each input byte: its index plus the escapes before it
    starts = torch.arange(W, device=x.device)[None, :] + extra.cumsum(1) - extra
    out = torch.zeros((B, S), dtype=torch.uint8, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, W)
    out[rows[valid], (starts + extra)[valid]] = mapped[valid]
    out[rows[grows], starts[grows]] = ESCAPE
    return out, elen


def unescape_rows(rows: torch.Tensor, lengths: torch.Tensor):
    """Escape-decode B rows at once.

    Args:
      rows: (B, C) uint8 escaped bytes; row b's first ``lengths[b]`` count.
      lengths: (B,) int32.

    Returns (flat, dec_lens): the decoded bytes of every row concatenated
    in row order (uint8, 1-d), and each row's decoded length (B,) int64.
    """
    valid = _valid(rows.shape, lengths)
    is_esc = (rows == ESCAPE) & valid
    if not bool(is_esc.any()):
        # no escape pairs: a byte map, lengths unchanged
        flat = torch.where(rows == ENCODED_OPENING, OPENING, rows)[valid]
        return flat, lengths.to(torch.int64)
    C = rows.shape[1]
    idx = torch.arange(C, dtype=torch.int32, device=rows.device)
    # last index at or before each position that is not 0x5C
    last_non = torch.where(is_esc, -1, idx[None, :]).cummax(1).values
    prev_non = torch.nn.functional.pad(last_non[:, :-1], (1, 0), value=-1)
    run_before = idx[None, :] - 1 - prev_non  # 0x5C bytes just before i
    escaped = (run_before & 1) == 1
    keep = valid & ~(is_esc & ~escaped)
    out = torch.where((rows == ENCODED_OPENING) & ~escaped, OPENING, rows)
    return out[keep], keep.sum(1)
