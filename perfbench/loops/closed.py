"""The closed loop: one host thread a client, each sending its next request when the last returns.

A phase runs every client against one function until its deadline; a
client whose call is in flight at the deadline finishes it, and the
phase ends when the last call has returned. A client sends the items of
its schedule (``generate.Traffic.schedule``).
"""

from __future__ import annotations

import contextlib
import threading
import time

from perfbench.clients import Call, Phase, report_failure


def run(direction: str, fn, inputs, traffic, sizes, seconds: float, keep,
        span=contextlib.nullcontext()) -> Phase:
    """Every client calls ``fn(inputs(item))`` on the items of its schedule until ``seconds`` have
    passed; ``keep(client, item, out)`` sees every answer. ``span`` is entered from the
    clients' release until the last has returned."""
    n = traffic.clients
    schedules = [traffic.schedule(c) for c in range(n)]
    gate = threading.Barrier(n + 1)
    calls: list[list[Call]] = [[] for _ in range(n)]
    phase = Phase(direction, 0.0, 0.0)

    def client(c: int) -> None:
        gate.wait()
        for item in schedules[c]:
            try:
                data = inputs(item)
            except KeyError:  # no input: what it is made from failed
                data = None
            start = time.perf_counter()
            if start >= phase.deadline:
                break
            if data is None:  # counted once as a failed call; the client stops
                calls[c].append(Call(c, item, start, start, sizes[item], False))
                break
            try:
                out, ok = fn(data), True
            except Exception:  # a failed call is counted and reported, and the client goes on
                report_failure(calls[c])
                out, ok = None, False
            end = time.perf_counter()
            calls[c].append(Call(c, item, start, end, sizes[item], ok))
            keep(c, item, out)
            del out  # an answer the check does not keep is freed here, outside the timed call

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}") for c in range(n)]
    for t in threads:
        t.start()
    with span:
        phase.start = time.perf_counter()
        phase.deadline = phase.start + seconds
        gate.wait()
        for t in threads:
            t.join()
    phase.calls = sorted((x for cs in calls for x in cs), key=lambda x: x.start)
    phase.end = max((x.end for x in phase.calls), default=phase.start)
    return phase
