"""What the metric readers under ``perfbench/metrics/`` share: a phase's calls, rates, tails and
its trace."""

from __future__ import annotations

from perfbench import stats, work


def calls(ctx, direction: str) -> list:
    """The phase's calls that returned an answer ([] without the phase)."""
    phase = ctx.phases.get(direction)
    return [c for c in phase.calls if c.ok] if phase else []


def rate_MBps(ctx, direction: str) -> float | None:
    """Bytes of every answered call, in 10^6 bytes, over the phase's wall time."""
    phase = ctx.phases.get(direction)
    if phase is None:
        return None
    return stats.rate(sum(c.nbytes for c in calls(ctx, direction)) / 1e6, phase.seconds())


def tail_ms(ctx, direction: str, q: float = 0.95) -> float | None:
    """The ``q`` quantile of every answered call's time, in ms."""
    return stats.tail([(c.end - c.start) * 1e3 for c in calls(ctx, direction)], q)


def trace(ctx, direction: str):
    """The phase's trace, or None in a run without one or where the profiler saw no device op (a run
    on the CPU: no device metric is read from it)."""
    phase = ctx.phases.get(direction)
    return phase.trace if phase and phase.trace and phase.trace.device else None


def per_call_ms(ctx, direction: str, seconds_of) -> float | None:
    """``seconds_of(trace)`` over the phase's answered calls, in ms a call."""
    t, n = trace(ctx, direction), len(calls(ctx, direction))
    if t is None or n == 0:
        return None
    return seconds_of(t) * 1e3 / n


def roofline_pct(ctx, direction: str, kernels: tuple[str, ...], least_s) -> float | None:
    """100 x the least time of the work of every answered call (``least_s(item stats)``) over the
    device time of the ops named ``kernels``; None where the trace has none of them."""
    t = trace(ctx, direction)
    if t is None:
        return None
    device_s = t.device_seconds(*kernels)
    if device_s <= 0:
        return None
    return 100.0 * sum(least_s(ctx.items[c.item]) for c in calls(ctx, direction)) / device_s


def coded(s: dict) -> int:
    """Coder steps of a container's arithmetic layer: its input symbols (the LZSS tokens where it
    has them) and an EOF a block."""
    return (s["tokens"] if s.get("tokens") is not None else s["bytes"]) + s["blocks"]


def least_s(nbytes: float, ops: float) -> float:
    return work.bound_s(nbytes, ops)[0]
