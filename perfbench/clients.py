"""What a phase of a run records, whatever loop sends its requests (``perfbench/loops/<loop>.py``).

Each call is timed on the host clock from its start to its returned
``bytes``. A loop looks an input up before the clock starts, and hands
the answer to the check's keeper after it stops.
"""

from __future__ import annotations

import sys
import traceback
from dataclasses import dataclass, field


@dataclass
class Call:
    client: int
    item: int
    start: float
    end: float
    nbytes: int  # the item's own size: bytes compressed, or bytes restored
    ok: bool


@dataclass
class Phase:
    direction: str
    start: float
    end: float
    deadline: float = 0.0
    calls: list[Call] = field(default_factory=list)
    trace: object = None  # profile.Trace of a traced run

    def seconds(self) -> float:
        return self.end - self.start


REPORTED_FAILURES = 3  # tracebacks printed a client and phase


def report_failure(done: list) -> None:
    """The traceback of one of a client's first failed calls, on standard error."""
    if sum(not x.ok for x in done) < REPORTED_FAILURES:
        traceback.print_exc(file=sys.stderr)
