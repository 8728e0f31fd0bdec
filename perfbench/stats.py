"""The arithmetic of the benchmark's numbers: rates, tails and busy time."""

from __future__ import annotations

import math


def rate(total: float, seconds: float) -> float | None:
    """All the work over all the time; None for an empty window."""
    return total / seconds if seconds > 0 and total > 0 else None


def tail(values: list[float], q: float = 0.95) -> float | None:
    """The nearest-rank ``q`` quantile of every value: the smallest value that at least a share
    ``q`` of them do not exceed."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def union_s(intervals: list[tuple[float, float]], lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of (start, end) intervals, each clipped to [lo, hi] where given."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def idle_pct(busy: float, window: float) -> float | None:
    """The share of the window, in %, in which the device ran nothing."""
    return 100.0 * (1.0 - busy / window) if window > 0 else None
