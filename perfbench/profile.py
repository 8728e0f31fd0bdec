"""The traced run's record: one torch.profiler session a phase, reduced to what the metrics read.

A session records every thread's host ranges (the program's
``record_function`` ranges, ``rsnb.*`` and ``stream.*``, and the
harness's ``perfbench.phase`` around the clients) and the card's kernels
and copies. :class:`Trace` keeps them as plain tuples in nanoseconds of
the profiler's clock:

- ``device``: (name, start, end, device index, id of the launching host
  op), every kernel, copy and memset, without the device-side copies of
  host ranges;
- ``ranges``: (name, start, end, thread), every host range;
- ``ops``: host op id -> (start, thread), to find the range a kernel was
  launched in.
"""

from __future__ import annotations

import re
from bisect import bisect_right
from dataclasses import dataclass, field

from perfbench import stats

PHASE_RANGE = "perfbench.phase"


def kernel_name(name: str) -> str:
    """A device op's name without namespace, template arguments or copy kinds' details."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "_".join(name.split()[:2])
    found = re.search(r"\w*_kernel\w*", name)
    return found.group(0) if found else name.split("(")[0].split("<")[0].split()[-1]


@dataclass
class Trace:
    device: list[tuple[str, int, int, int, int]] = field(default_factory=list)
    ranges: list[tuple[str, int, int, int]] = field(default_factory=list)
    ops: dict[int, tuple[int, int]] = field(default_factory=dict)
    cards: int = 1

    def window(self) -> tuple[int, int]:
        """The phase's span: the harness's range around the clients."""
        spans = [(s, e) for name, s, e, _ in self.ranges if name == PHASE_RANGE]
        return spans[0] if spans else (0, 0)

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) / 1e9

    def busy_s(self) -> float:
        """Seconds in which a device op ran, inside the window, averaged over the cell's cards."""
        lo, hi = self.window()
        per = {}
        for _, s, e, dev, _ in self.device:
            per.setdefault(dev, []).append((s, e))
        return sum(stats.union_s(v, lo, hi) for v in per.values()) / 1e9 / self.cards

    def device_seconds(self, *names: str) -> float:
        """Device seconds of the ops whose name contains any of ``names``."""
        return sum(e - s for n, s, e, _, _ in self.device if any(k in n for k in names)) / 1e9

    def by_kernel(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n, s, e, _, _ in self.device:
            k = kernel_name(n)
            out[k] = out.get(k, 0.0) + (e - s) / 1e9
        return out

    def spans(self, name: str) -> list[tuple[int, int, int]]:
        """(start, end, thread) of every host range ``name``."""
        return [(s, e, t) for n, s, e, t in self.ranges if n == name]

    def launched_under_s(self, name: str) -> float:
        """Device seconds of the ops launched from inside a host range ``name``."""
        within: dict[int, list[tuple[int, int]]] = {}
        for s, e, t in self.spans(name):
            within.setdefault(t, []).append((s, e))
        for v in within.values():
            v.sort()
        total = 0
        for _, s, e, _, op in self.device:
            at = self.ops.get(op)
            if at is None or at[1] not in within:
                continue
            spans = within[at[1]]
            i = bisect_right(spans, (at[0], float("inf"))) - 1
            if i >= 0 and spans[i][0] <= at[0] <= spans[i][1]:
                total += e - s
        return total / 1e9

    def self_s(self, name: str) -> float:
        """Host seconds of the ranges ``name`` outside the ranges nested in them on their thread."""
        threads: dict[int, list[tuple[int, int]]] = {}
        for n, s, e, t in self.ranges:
            if n != name:
                threads.setdefault(t, []).append((s, e))
        for v in threads.values():
            v.sort()
        total = 0
        for s, e, t in self.spans(name):
            v = threads.get(t, [])
            inner = [(a, b) for a, b in v[bisect_right(v, (s, -1)) : bisect_right(v, (e, e))] if b <= e]
            total += (e - s) - stats.union_s(inner)
        return total / 1e9

    def idle_gaps(self) -> dict[str, float]:
        """Seconds in which no device ran anything, by the innermost program range that each client
        thread was in at the gap's middle (shared equally among the threads)."""
        lo, hi = self.window()
        busy = [(s, e) for _, s, e, _, _ in self.device]
        threads: dict[int, list[tuple[int, int, str]]] = {}
        for n, s, e, t in self.ranges:
            if n != PHASE_RANGE:
                threads.setdefault(t, []).append((s, e, n))
        for v in threads.values():
            v.sort()
        out: dict[str, float] = {}
        for a, b in stats.gaps(busy, lo, hi):
            mid = (a + b) / 2
            names = []
            for v in threads.values():
                # ranges nest: the innermost one around mid is the latest-starting one still open
                i = bisect_right(v, (mid, float("inf"), "")) - 1
                while i >= 0 and v[i][1] < mid:
                    i -= 1
                if i >= 0:
                    names.append(v[i][2])
            names = names or ["(outside the program's ranges)"]
            for n in names:
                out[n] = out.get(n, 0.0) + (b - a) / 1e9 / len(names)
        return out


class Session:
    """One profiler session over one phase: :meth:`start`, then :meth:`stop` -> :class:`Trace`."""

    def __init__(self, cards: int):
        self.cards = cards
        self.prof = None

    def start(self) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # the clients are threads of their own: record every thread's ranges
        self.prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.start()

    def stop(self) -> Trace:
        from torch.autograd import DeviceType

        self.prof.stop()
        trace = Trace(cards=self.cards)
        for e in self.prof.profiler.kineto_results.events():
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if e.is_user_annotation():
                    trace.ranges.append((e.name(), start, end, e.start_thread_id()))
                trace.ops[e.correlation_id()] = (start, e.start_thread_id())
            elif not e.is_user_annotation():
                trace.device.append((e.name(), start, end, e.device_index(), e.linked_correlation_id()))
        self.prof = None
        return trace
