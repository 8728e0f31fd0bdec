"""Small helpers (parity with reference engine/util.go): the port's copy of raisin_tpu/utils/misc.py."""

from __future__ import annotations

import threading


def byte_count_si(n: int) -> str:
    """Human-readable SI byte count (reference: engine/util.go:30).

    1000-based units, one decimal place: 999 -> "999 B", 1000 -> "1.0 kB".
    """
    unit = 1000
    if n < unit:
        return f"{n} B"
    div, exp = unit, 0
    while n >= div * unit and exp < 5:
        div *= unit
        exp += 1
    return f"{n / div:.1f} {'kMGTPE'[exp]}B"


def wait_timeout(threads, timeout: float) -> bool:
    """Join threads with a total timeout; True if timed out.

    Parity with engine/util.go:15 (waitTimeout over a WaitGroup).
    """
    deadline = threading.Event()

    def _join_all():
        for t in threads:
            t.join()
        deadline.set()

    waiter = threading.Thread(target=_join_all, daemon=True)
    waiter.start()
    return not deadline.wait(timeout)
