"""The least work of kernels G and H, the Huffman coder's, for their rooflines.

Frozen copies of ``chip_smoke.py``'s bounds of kernel G (``_encode_bound``)
and kernel H (``hdecode_result``), taken from a container's sizes alone
(its token bytes, its payload bytes and its blocks), never from the
program's counters, so that a later kernel that does the same work another
way reads against the same bound. ``perfbench/work.py`` holds the card's
peaks and ``bound_s``.
"""

from __future__ import annotations

NSYM = 128  # a block's code table entries, each a 4-byte code and a 4-byte length
NTAB = 64  # a block's child table, in 4-byte words


def encode_work(tokens: float, payload: float, blocks: int) -> tuple[float, float]:
    """Kernel G: the token bytes and each block's code table in, the payloads and their lengths out;
    per symbol a code load, a scan add, a shift and an OR."""
    return tokens + 8 * NSYM * blocks + payload + 8 * blocks, 4 * tokens


def decode_work(tokens: float, payload: float, blocks: int) -> tuple[float, float]:
    """Kernel H: the payloads and each block's child table in, the token bytes and their counts out;
    a table step a symbol, at 4 operations."""
    return payload + 4 * NTAB * blocks + tokens + 8 * blocks, 4 * tokens
