"""Block pipelines on tensors (the port of raisin_tpu/ops/pipeline_jax.py)."""

from __future__ import annotations

import torch

from raisin_tpu_torch.ops import arithmetic_rows


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
