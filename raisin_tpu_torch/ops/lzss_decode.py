"""LZSS token walk: the port of raisin_tpu/ops/lzss_decode_pallas.py:lzss_decode_blocks.

:func:`decode_tokens` turns B token streams back into their escaped
plaintexts, following the reference state machine (lzss.go:323, oracle
raisin_tpu/formats/lzss_ref.py:decompress): outside a token every byte
but ``<`` is a literal; ``<`` opens a token, whose bytes up to ``,`` are
the distance D and up to ``>`` the length L; the token then copies
``out[len - D : len - D + L]``. A number that is not all decimal digits
counts as 0 (Go's Atoi error fallback; signs and spaces are not read),
values saturate at 2**30, and a stream that ends inside a token drops it.
A reference with ``D > len`` or ``L > D`` lies outside the decoded output,
which raises ValueError as the oracle does; since ``L <= D`` on every
valid stream, a copy never overlaps its source.

Kernel F (csrc/lzss_decode.cu) takes each stream with a CTA: scans parse
it a tile at a time, the output is staged in shared memory, and the
copies resolve in rounds of ready tokens; no side table. The plain version
:func:`_walk_tokens_torch` works on all positions at once: the state before
each byte comes from a prefix composition of the 3-state transition
functions, the numbers from a prefix composition of saturating affine maps
``v -> min(10 v + digit, 2**30)``, every output byte gets its source (a
literal of the stream, or output position ``o - D``), and pointer doubling
(``ptr = ptr[ptr]``) resolves the chains of copies.

Per-block error codes of :func:`walk_tokens`: 0 ok, 1 a reference outside
the decoded output, 2 output past ``cap_out``; either stops the walk at
the first fault in stream order. A faulty block's row is zeroed and its
``out_len`` is 0.
"""

from __future__ import annotations

import torch

from raisin_tpu_torch.ops import _build
from raisin_tpu_torch.ops.arithmetic_rows import _check_cuda
from raisin_tpu_torch.ops.lzss_commit import CLOSING, OPENING, SEP

SATURATE = 1 << 30  # numbers saturate here; cap_out must stay below it
ERR_REFERENCE, ERR_CAPACITY = 1, 2


def _prefix_compose(a: torch.Tensor, b: torch.Tensor, identity_a: int):
    """Inclusive prefix composition along dim 1 of maps ``v -> min(a v + b, SATURATE)``."""
    S = a.shape[1]
    k = 1
    while k < S:
        pa = torch.nn.functional.pad(a[:, :-k], (k, 0), value=identity_a)
        pb = torch.nn.functional.pad(b[:, :-k], (k, 0), value=0)
        # earlier map (pa, pb) first, then (a, b)
        a, b = (a * pa).clamp(max=SATURATE), (a * pb + b).clamp(max=SATURATE)
        k *= 2
    return a, b


def _states_before(t: torch.Tensor) -> torch.Tensor:
    """State (0 outside a token, 1 in D, 2 in L) before each byte."""
    B, S = t.shape
    # the transition as a table g[s] for s = 0, 1, 2
    g = torch.stack(
        [torch.where(t == OPENING, 1, 0), torch.where(t == SEP, 2, 1), torch.where(t == CLOSING, 0, 2)],
        dim=-1,
    )
    ident = torch.arange(3, device=t.device).expand(B, S, 3)
    k = 1
    while k < S:
        prev = torch.cat([ident[:, :k], g[:, :-k]], dim=1)
        g = g.gather(2, prev)  # g(prev(s))
        k *= 2
    after = g[:, :, 0]
    return torch.nn.functional.pad(after[:, :-1], (1, 0), value=0)


def _walk_tokens_torch(tok: torch.Tensor, tok_len: torch.Tensor, cap_out: int):
    """Plain version of kernel F: (rows (B, cap_out) uint8, out_len (B,), err (B,)), int32."""
    B, S = tok.shape
    dev = tok.device
    rows = torch.zeros((B, cap_out), dtype=torch.uint8, device=dev)
    out_len = torch.zeros(B, dtype=torch.int32, device=dev)
    err = torch.zeros(B, dtype=torch.int32, device=dev)
    if S == 0 or B == 0:
        return rows, out_len, err
    pos = torch.arange(S, dtype=torch.int64, device=dev)
    t = tok.to(torch.int64)
    valid = pos[None, :] < tok_len.to(torch.int64)[:, None]
    state = _states_before(t)
    literal = valid & (state == 0) & (t != OPENING)
    opener = valid & (state == 0) & (t == OPENING)
    sep = valid & (state == 1) & (t == SEP)
    close = valid & (state == 2) & (t == CLOSING)
    in_num = valid & (((state == 1) & (t != SEP)) | ((state == 2) & (t != CLOSING)))
    is_digit = (t >= 0x30) & (t <= 0x39)

    # number values: reset at '<' and ',', v -> 10 v + digit inside
    a = torch.where(opener | sep, 0, torch.where(in_num, 10, 1))
    b = torch.where(in_num & is_digit, t - 0x30, 0)
    _, value = _prefix_compose(a, b, 1)
    value_before = torch.nn.functional.pad(value[:, :-1], (1, 0))
    bad = (in_num & ~is_digit).to(torch.int64).cumsum(1)
    bad_before = torch.nn.functional.pad(bad[:, :-1], (1, 0))
    neg = torch.full_like(pos, -1)[None, :]
    open_at = torch.where(opener, pos[None, :], neg).cummax(1).values.clamp(min=0)
    sep_at = torch.where(sep, pos[None, :], neg).cummax(1).values.clamp(min=0)
    # at each ',': D; at each '>': L, and D from its ','
    d_here = torch.where(bad_before - bad.gather(1, open_at) > 0, 0, value_before)
    Dv = d_here.gather(1, sep_at)
    Lv = torch.where(bad_before - bad.gather(1, sep_at) > 0, 0, value_before)

    contrib = torch.where(literal, 1, torch.where(close, Lv, 0))
    end = contrib.cumsum(1)
    start = end - contrib
    fault = torch.where(close & ((Dv > start) | (Lv > Dv)), ERR_REFERENCE, 0)
    fault = torch.where((fault == 0) & (literal | close) & (end > cap_out), ERR_CAPACITY, fault)
    has = fault > 0
    first = torch.where(has, pos[None, :], S).amin(1)
    err = torch.where(first < S, fault.gather(1, first.clamp(max=S - 1)[:, None])[:, 0], 0).to(torch.int32)
    total = end[:, -1]
    ok = err == 0

    # every output byte's source: itself for a literal, o - D inside a copy
    seg = literal | (close & (Lv > 0))
    q = torch.where(seg & ok[:, None] & (start < cap_out), start, cap_out)  # cap_out: a dump slot
    seg_start = torch.full((B, cap_out + 1), -1, dtype=torch.int64, device=dev)
    seg_start.scatter_(1, q, torch.where(q < cap_out, q, -1))
    seg_d = torch.zeros((B, cap_out + 1), dtype=torch.int64, device=dev)
    seg_d.scatter_(1, q, torch.where(literal, 0, Dv))
    val = torch.zeros((B, cap_out + 1), dtype=torch.int64, device=dev)
    val.scatter_(1, q, torch.where(literal, t, 0))
    o = torch.arange(cap_out + 1, dtype=torch.int64, device=dev)[None, :]
    cur = seg_start.cummax(1).values.clamp(min=0)
    live = o < torch.where(ok, total, 0)[:, None]
    ptr = torch.where(live, o - seg_d.gather(1, cur), o).clamp(min=0)
    for _ in range(max(1, cap_out.bit_length())):
        ptr = ptr.gather(1, ptr)
    rows = torch.where(live, val.gather(1, ptr), 0)[:, :cap_out].to(torch.uint8)
    out_len = torch.where(ok, total, 0).to(torch.int32)
    return rows.contiguous(), out_len, err


def walk_tokens(tok: torch.Tensor, tok_len: torch.Tensor, cap_out: int, stats: torch.Tensor | None = None):
    """Kernel F, or its plain version: (rows (B, cap_out) uint8, out_len, err), int32.

    Args:
      tok: (B, S) uint8 token streams (what lies past ``tok_len`` is ignored).
      tok_len: (B,) int32, each <= S.
      cap_out: output bytes per row, < 2**30.
      stats: optional (B, 2) int32 on the card, for the kernel only: each
        block's rounds over its tiles' tokens and the steps of the one-warp
        walk that takes over a tile's slow tail.
    """
    if not 0 <= cap_out < SATURATE:
        raise ValueError(f"cap_out must lie in [0, {SATURATE})")
    if tok.device.type == "cpu":
        return _walk_tokens_torch(tok, tok_len, cap_out)
    B, S = _check_cuda("walk_tokens", tok, torch.uint8, 2)
    _check_cuda("walk_tokens", tok_len, torch.int32, 1, (B,), tok.device)
    if stats is not None:
        _check_cuda("walk_tokens", stats, torch.int32, 2, (B, 2), tok.device)
    dev = tok.device
    if B == 0 or S == 0:
        empty = torch.zeros(B, dtype=torch.int32, device=dev)
        return torch.zeros((B, cap_out), dtype=torch.uint8, device=dev), empty, empty.clone()
    # the kernel writes every byte of the rows, zeros past out_len and in a faulty row
    rows = torch.empty((B, cap_out), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        walk_tokens.launches += 1
        rc = lib.rsn_lzss_decode(
            tok.data_ptr(), tok_len.data_ptr(), rows.data_ptr(), out_len.data_ptr(),
            err.data_ptr(), 0 if stats is None else stats.data_ptr(), B, S, cap_out, _build.stream_handle(dev),
        )
    _build.check("rsn_lzss_decode", rc)
    return rows, out_len, err


walk_tokens.launches = 0


def decode_tokens(tok: torch.Tensor, tok_len: torch.Tensor, cap_out: int, first_block: int = 0):
    """Decode B token streams to their escaped plaintexts.

    Returns (rows (B, cap_out) uint8, zero past ``out_len``; out_len (B,)
    int32). Raises ValueError, naming block ``first_block + b``, when a
    stream references bytes outside its decoded output or decodes past
    ``cap_out`` bytes.
    """
    rows, out_len, err = walk_tokens(tok, tok_len, cap_out)
    bad = torch.nonzero(err).flatten()
    if bad.numel():
        i = int(bad[0])
        what = "reference outside decoded window" if int(err[i]) == ERR_REFERENCE else "output past its capacity"
        raise ValueError(f"lzss: block {first_block + i}: {what}")
    return rows, out_len
