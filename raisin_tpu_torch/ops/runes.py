"""Go's rune iteration and its inverse on tensors: the counterparts of raisin_tpu/formats/huffman_ref.py.

:func:`decode` is ``decode_runes_array`` (:157) with its fast path
``go_decode_runes_np`` (:101) and its exact sequential fallback
``go_decode_runes`` (:40): the runes of ``for _, c := range string(b)``,
where every byte that does not begin a valid UTF-8 sequence is one U+FFFD
of width 1. :func:`encode_utf8` is ``runes_to_utf8_np`` (:166). The JAX
package runs both in numpy on the host and loops in Python over an input
with an invalid byte; here both are elementwise work and one scan on the
device the bytes lie on, as the escape layer (``ops/escape.py``) is.

Rune starts are local, so the decode needs no loop. Validity follows Go's
``utf8.DecodeRune``: a lead byte C2-DF takes one continuation (80-BF), E0-EF
two and F0-F4 three, where the second byte of E0 lies in A0-BF, of ED in
80-9F, of F0 in 90-BF and of F4 in 80-8F; 80-C1 and F5-FF never lead, and a
sequence cut by the end of the input is invalid. A byte that is not a
continuation always starts a rune (no valid sequence holds one past its
first byte). A continuation byte starts a rune (U+FFFD) unless a valid
sequence that begins one to three bytes before it covers it: such a
sequence begins on a lead byte, which is always a start. So one pass over
each position and its next three bytes gives every start and every rune.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RUNE_ERROR = 0xFFFD


def _widths(x: torch.Tensor):
    """(width of the valid sequence starting at each byte, 0 where none does; the bytes b0..b3), int32."""
    n = x.numel()
    p = F.pad(x.to(torch.int32), (0, 3), value=-1)  # -1: past the end, never a continuation
    b0, b1, b2, b3 = (p[k : k + n] for k in range(4))

    def cont(b, lo=0x80, hi=0xBF):
        return (b >= lo) & (b <= hi)

    lo3 = torch.where(b0 == 0xE0, 0xA0, 0x80)
    hi3 = torch.where(b0 == 0xED, 0x9F, 0xBF)
    lo4 = torch.where(b0 == 0xF0, 0x90, 0x80)
    hi4 = torch.where(b0 == 0xF4, 0x8F, 0xBF)
    v2 = (b0 >= 0xC2) & (b0 <= 0xDF) & cont(b1)
    v3 = (b0 >= 0xE0) & (b0 <= 0xEF) & cont(b1, lo3, hi3) & cont(b2)
    v4 = (b0 >= 0xF0) & (b0 <= 0xF4) & cont(b1, lo4, hi4) & cont(b2) & cont(b3)
    w = torch.where(b0 < 0x80, 1, 0) + 2 * v2 + 3 * v3 + 4 * v4
    return w.to(torch.int32), (b0, b1, b2, b3)


def decode(x: torch.Tensor) -> torch.Tensor:
    """Go's runes of the bytes ``x`` ((N,) uint8) as an (M,) int32 tensor on the same device."""
    n = x.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=x.device)
    w, (b0, b1, b2, b3) = _widths(x)
    # covered: a valid sequence that began k = 1..3 bytes earlier is longer than k
    wp = F.pad(w, (3, 0))
    covered = (wp[2 : 2 + n] > 1) | (wp[1 : 1 + n] > 2) | (wp[:n] > 3)
    c1, c2, c3 = b1 & 0x3F, b2 & 0x3F, b3 & 0x3F
    cp = torch.where(
        w == 1, b0,
        torch.where(
            w == 2, ((b0 & 0x1F) << 6) | c1,
            torch.where(
                w == 3, ((b0 & 0x0F) << 12) | (c1 << 6) | c2,
                torch.where(w == 4, ((b0 & 0x07) << 18) | (c1 << 12) | (c2 << 6) | c3, RUNE_ERROR),
            ),
        ),
    )
    return cp[~covered].to(torch.int32)


def encode_utf8(runes: torch.Tensor) -> torch.Tensor:
    """UTF-8 bytes of (M,) int32 runes ((L,) uint8, same device); a negative rune, a surrogate
    or one past U+10FFFF becomes U+FFFD, as in ``runes_to_utf8_np``."""
    r = runes.to(torch.int32)
    bad = (r < 0) | (r > 0x10FFFF) | ((r >= 0xD800) & (r <= 0xDFFF))
    r = torch.where(bad, RUNE_ERROR, r)
    w = 1 + (r >= 0x80).to(torch.int32) + (r >= 0x800).to(torch.int32) + (r >= 0x10000).to(torch.int32)
    ends = w.to(torch.int64).cumsum(0)
    total = int(ends[-1]) if r.numel() else 0
    out = torch.zeros(total, dtype=torch.uint8, device=r.device)
    if total == 0:
        return out
    off = ends - w
    lead = torch.where(w == 1, r, torch.where(w == 2, 0xC0 | (r >> 6), torch.where(w == 3, 0xE0 | (r >> 12), 0xF0 | (r >> 18))))
    out[off] = lead.to(torch.uint8)
    for k in range(1, 4):  # byte k of a rune of width w > k: bits 6 * (w - 1 - k) and up
        m = w > k
        shift = 6 * (w[m] - 1 - k)
        out[off[m] + k] = (0x80 | ((r[m] >> shift) & 0x3F)).to(torch.uint8)
    return out
