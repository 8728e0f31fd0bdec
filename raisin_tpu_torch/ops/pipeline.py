"""Block pipelines on tensors (the port of raisin_tpu/ops/pipeline_jax.py)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from raisin_tpu_torch.ops import arithmetic_rows, lzss_commit, lzss_match


def arith_symbols(payload: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, S) uint8 block bytes -> (B, S) int32 coder symbols.

    EOF (256) goes at each block's length and past it, as
    pipeline_jax.arith_encode_rows does; every length must be < S.
    """
    S = payload.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=payload.device)
    symbols = torch.where(
        pos[None, :] < lengths[:, None], payload.to(torch.int32), arithmetic_rows.EOF
    )
    return symbols.to(torch.int32).contiguous()


def arith_encode_rows(payload: torch.Tensor, lengths: torch.Tensor):
    """Pure-arithmetic container encode of a block batch to `.rsn` rows.

    payload: (B, S) uint8, zero past each length; lengths: (B,) int32.
    Returns :func:`arithmetic_rows.encode_rows`'s ``(rows, byte_lens, oflow)``.
    """
    return arithmetic_rows.encode_rows(arith_symbols(payload, lengths), lengths)


def lzss_tokens(x: torch.Tensor, lengths: torch.Tensor, window: int):
    """LZSS match search and commit of escaped blocks (pipeline_jax.lzss_tokens_words).

    x: (B, S) uint8 escaped bytes; lengths: (B,) int32. Returns
    (tok (B, S) uint8, tok_len (B,) int32): kernel D, then kernel E. The
    JAX package packs the tokens into words for its SMEM layout; here they
    stay bytes.
    """
    with record_function("rsnb.enc.match"):
        L, D = lzss_match.find_matches(x, lengths, window)
    with record_function("rsnb.enc.commit"):
        return lzss_commit.commit_tokens(x, L, D, lengths)


def lzss_arith_encode_rows(x: torch.Tensor, lengths: torch.Tensor, window: int):
    """lzss,arithmetic encode of escaped blocks to `.rsn` rows.

    The counterpart of pipeline_jax.lzss_arith_encode_rows and
    arith_rows_from_words: the token bytes go through kernels A and B at
    ``max(tok_len) + 1`` steps (one small host sync reads the max).
    Returns (rows, byte_lens, tok_len, oflow).
    """
    tok, tok_len = lzss_tokens(x, lengths, window)
    with record_function("rsnb.enc.coder"):
        steps = int(tok_len.max()) + 1 if tok_len.numel() else 1
        payload = torch.nn.functional.pad(tok[:, : steps - 1], (0, 1))
        rows, byte_lens, oflow = arith_encode_rows(payload, tok_len)
    return rows, byte_lens, tok_len, oflow
