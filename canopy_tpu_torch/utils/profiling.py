"""Observability: phase timers and a ``torch.profiler`` trace context.

Structured phase timers feed ``RiskAnalysis`` timings; :func:`trace`
records the analysis with ``torch.profiler`` (CPU and, on a CUDA device,
kernel activity) and writes a Chrome trace plus a table of the slowest
operators into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["PhaseTimer", "trace"]


class PhaseTimer:
    """Accumulating named phase timers."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, float]:
        return dict(self.times)


@contextlib.contextmanager
def trace(log_dir: str | None, cuda: bool = False):
    """`torch.profiler` trace context (no-op when log_dir is None).

    Writes ``trace.json`` (Chrome trace format) and ``ops.txt`` (the
    operator table by total time) into ``log_dir``; ``cuda`` adds the
    device activity.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort_by = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(log_dir, "ops.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))
