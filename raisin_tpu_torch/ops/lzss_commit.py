"""LZSS greedy commit and token emission: the port of
raisin_tpu/ops/lzss_commit_pallas.py:commit_emit_words.

:func:`commit_tokens` walks each block as the reference does (lzss.go:134-151,
oracle raisin_tpu/formats/lzss_ref.py:commit_tokens): at position i with
match (L, D), a reference token ``<D,L>`` is written only when it is
strictly shorter than L; otherwise the L matched bytes are copied; either
way L positions are consumed. L <= 1 is one literal. D and L take up to 5
decimal digits (windows above 9999), so a token is at most 13 bytes; the
JAX kernel stops at 4 digits.

Kernel E (csrc/lzss_commit.cu) walks each block in parallel segments of SEG
positions, SPAN_SEGS segments a CTA (a span): each segment walks greedily
from its first position, then the segments repair their entries from the
exits before them (walks from different positions soon land on a common
position); a second device kernel chains the spans of each block in order
and scans the byte counts into offsets, a third writes the bytes. The
plain version :func:`_commit_tokens_torch` is the pointer-doubling
formulation of raisin_tpu/ops/lzss_jax.py:commit_blocks: the committed
positions are the orbit of 0 under ``f(i) = i + max(L[i], 1)``, found here
by doubling a reachable set (``M |= f(M)``, then ``f = f(f)``) instead of
by rank, and each output byte finds its position by a binary search over
the output offsets. The two formulations check each other.
"""

from __future__ import annotations

import torch

from raisin_tpu_torch.ops import _build
from raisin_tpu_torch.ops.arithmetic_rows import _check_cuda

OPENING, SEP, CLOSING = 0x3C, 0x2C, 0x3E  # the token syntax "<D,L>"; the walk reads it
SEG = 64  # positions a segment (csrc/lzss_commit.cu)
SPAN_SEGS = 256  # segments a CTA


def _ndigits(v: torch.Tensor) -> torch.Tensor:
    return 1 + sum((v >= 10**k).to(v.dtype) for k in range(1, 5))


def _digit_at(v: torch.Tensor, p: torch.Tensor, nd: torch.Tensor) -> torch.Tensor:
    """ASCII digit ``p`` (0 = most significant) of the ``nd``-digit decimal v."""
    pow10 = 10 ** (nd - 1 - p).clamp(0, 4)
    return (v // pow10) % 10 + ord("0")


def _commit_tokens_torch(x, L, D, lengths):
    """Plain version of kernel E: (tok (B, S) uint8, tok_len (B,) int32)."""
    B, S = x.shape
    dev = x.device
    if S == 0:
        return torch.zeros((B, 0), dtype=torch.uint8, device=dev), torch.zeros(B, dtype=torch.int32, device=dev)
    n = lengths.to(torch.int64)
    pos = torch.arange(S, dtype=torch.int64, device=dev)
    # a match never runs past the block (kernel E clamps the same way)
    Lq = torch.minimum(L.to(torch.int64), n[:, None] - pos[None, :])
    Dq = D.to(torch.int64)
    nd_d, nd_l = _ndigits(Dq), _ndigits(Lq)
    tok_len_at = 3 + nd_d + nd_l
    use_tok = (Lq > 0) & (tok_len_at < Lq)
    consumed = Lq.clamp(min=1)
    out_len_at = torch.where(use_tok, tok_len_at, consumed)

    # orbit of 0 under f, with S as the terminal state
    f = torch.full((B, S + 1), S, dtype=torch.int64, device=dev)
    f[:, :S] = (pos[None, :] + consumed).clamp(max=S)
    mark = torch.zeros((B, S + 1), dtype=torch.int32, device=dev)
    mark[:, 0] = 1
    for _ in range(max(1, S.bit_length())):
        mark.scatter_reduce_(1, f, mark.clone(), reduce="amax")
        f = f.gather(1, f)
    committed = mark[:, :S].bool() & (pos[None, :] < n[:, None])

    lens = torch.where(committed, out_len_at, 0)
    ends = lens.cumsum(1)
    total = ends[:, -1]
    starts = ends - lens
    # output byte o belongs to the committed position r whose span holds it
    o = pos[None, :].expand(B, S).contiguous()
    r = torch.searchsorted(ends, o, right=True).clamp(max=S - 1)
    within = o - starts.gather(1, r)
    d_src, l_src = Dq.gather(1, r), Lq.gather(1, r)
    ndd, ndl = nd_d.gather(1, r), nd_l.gather(1, r)
    tok_byte = torch.where(
        within == 0, OPENING,
        torch.where(
            within <= ndd, _digit_at(d_src, within - 1, ndd),
            torch.where(
                within == ndd + 1, SEP,
                torch.where(within <= ndd + 1 + ndl, _digit_at(l_src, within - ndd - 2, ndl), CLOSING),
            ),
        ),
    )
    raw_byte = x.gather(1, (r + within).clamp(max=S - 1)).to(torch.int64)
    out = torch.where(use_tok.gather(1, r), tok_byte, raw_byte)
    out = torch.where(o < total[:, None], out, 0)
    return out.to(torch.uint8), total.to(torch.int32)


def workspace_bytes(B: int, S: int) -> int:
    """Kernel E's workspace for B blocks of S positions: 16 bytes for each of its segments."""
    spans = max(1, -(-S // (SEG * SPAN_SEGS)))
    return 16 * B * spans * SPAN_SEGS


def commit_tokens(x: torch.Tensor, L: torch.Tensor, D: torch.Tensor, lengths: torch.Tensor):
    """Greedy commit and ASCII token emission (kernel E, or its plain version).

    Args:
      x: (B, S) uint8 escaped block bytes; L, D: (B, S) int32 matches
        (:func:`raisin_tpu_torch.ops.lzss_match.find_matches`); lengths: (B,)
        int32.

    Returns (tok (B, S) uint8, zero past ``tok_len``; tok_len (B,) int32).
    A token is only written when shorter than its match, so the stream
    never outgrows the block.
    """
    if x.device.type == "cpu":
        return _commit_tokens_torch(x, L, D, lengths)
    B, S = _check_cuda("commit_tokens", x, torch.uint8, 2)
    for t in (L, D):
        _check_cuda("commit_tokens", t, torch.int32, 2, (B, S), x.device)
    _check_cuda("commit_tokens", lengths, torch.int32, 1, (B,), x.device)
    dev = x.device
    tok = torch.zeros((B, S), dtype=torch.uint8, device=dev)
    tok_len = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or S == 0:
        return tok, tok_len
    work = torch.empty(workspace_bytes(B, S) // 8, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _build.count(commit_tokens)
        rc = lib.rsn_lzss_commit(
            x.data_ptr(), L.data_ptr(), D.data_ptr(), lengths.data_ptr(),
            tok.data_ptr(), tok_len.data_ptr(), work.data_ptr(), B, S, _build.stream_handle(dev),
        )
    _build.check("rsn_lzss_commit", rc)
    return tok, tok_len


commit_tokens.launches = 0
