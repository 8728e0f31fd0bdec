"""The yardstick of the kernels' rooflines: the card's peaks and each kernel's least work.

Frozen copies of ``chip_smoke.py``'s ``PEAK_BYTES_PER_S``,
``PEAK_INT_OPS_PER_S``, ``bound`` and the least-work counts of kernels D,
A, B, C and I, taken from the sizes of a call's input and output alone,
never from the program's counters, so that a later kernel that does the
same work another way reads against the same bound.

Peaks of one NVIDIA H100 SXM (data sheet): 3.35 TB/s of HBM, and an INT32
issue rate of 132 SMs x 64 lanes at the 1.98 GHz that the data sheet's
67 TFLOP/s of float32 implies (a quarter of that float32 rate).
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 132 * 64 * 1.98e9
NUM_CUM = 258  # the arithmetic model's cumulative counts


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds the card could take, what sets it): bytes over the memory rate or operations
    over the INT32 rate, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def coder_ops(steps: float, bits: float) -> float:
    """Least integer operations of the adaptive arithmetic coder: per step a search and an update of
    a Fenwick tree of NUM_CUM entries (ceil(log2) operations each) and ~6 of coder arithmetic; one a
    stream bit."""
    return (2 * math.ceil(math.log2(NUM_CUM)) + 6) * steps + bits


def match_work(escaped: float, window: int) -> tuple[float, float]:
    """Kernel D: the escaped bytes in, (L, D) out; a binary-tree match finder visits ~log2(window)
    nodes a position."""
    return 9 * escaped, math.ceil(math.log2(window)) * escaped


def encode_work(coded: float, stream: float, blocks: int) -> tuple[float, float]:
    """Kernel A: int32 symbols in and the stream out, a coder step a symbol and EOF (``coded``
    steps, ``stream`` bytes)."""
    return 4 * coded + stream + 12 * blocks, coder_ops(coded, 8 * stream)


def prepad_work(stream: float, payload: float, blocks: int) -> tuple[float, float]:
    """Kernel B: the stream's bytes in, the prepadded payloads out."""
    return stream + payload + 8 * blocks, 6 * payload / 4


def decode_work(coded: float, payload: float, blocks: int) -> tuple[float, float]:
    """Kernel C: the payloads in, the decoded bytes out (``coded`` steps, EOF included)."""
    return payload + coded - blocks + 4 * blocks, coder_ops(coded, 8 * payload)


def events_work(steps: float, bits: float) -> tuple[float, float]:
    """Kernel I: symbols in, 16 slot bytes and slot0 out a step; ``bits`` the stream's, prepad
    included."""
    return 24 * steps, coder_ops(steps, bits)
