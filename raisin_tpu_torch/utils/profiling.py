"""Profiling/tracing hooks: the port of raisin_tpu/utils/profiling.py.

- :func:`trace` — context manager around ``torch.profiler.profile``: host
  activity, plus the card's kernels and copies when PyTorch sees a card,
  written on exit, also when the body raises, as a Chrome trace file into
  ``log_dir`` (CLI: ``-profile[=DIR]``). The engine's ``stream.*`` and the
  container's ``rsnb.*`` ranges appear in it by name.
- :class:`StageTimer` — wall-clock per-stage breakdown, as in the JAX
  package.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "raisin_tpu_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """Profile the body; on exit write ``log_dir/trace-<pid>-<ns>.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("match"): ...
    >>> t.report()  # {'match': 0.12, ...}
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
