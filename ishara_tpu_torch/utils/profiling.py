"""Profiling helpers (port of ``ishara_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, and the throughput
counter."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """Profile the block's host and CUDA activity with ``torch.profiler``
    and write it to ``logdir/trace.json`` (Chrome trace format, viewable in
    Perfetto or ``chrome://tracing``). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class Throughput:
    """Sliding seqs/sec counter. ``update(batch_size)`` per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n: int) -> float:
        now = time.perf_counter()
        self._events.append((now, n))
        if len(self._events) > self.window:
            self._events.pop(0)
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        total = sum(k for _, k in self._events[1:])
        return total / dt if dt > 0 else 0.0
