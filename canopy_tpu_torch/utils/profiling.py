"""Observability: phase timers, roofline accounting and a trace context.

Structured phase timers feed ``RiskAnalysis`` timings; a roofline
accountant turns (bytes moved, elements processed, elapsed) into
achieved-fraction numbers against the card's memory rate; :func:`trace`
records the analysis with ``torch.profiler`` (CPU and, on a CUDA device,
kernel activity) and writes a Chrome trace plus a table of the slowest
operators into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time

from ..errors import LogicError

__all__ = ["PhaseTimer", "RooflineAccountant", "trace"]


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


#: Device-memory bandwidth (bytes/s) by ``torch.cuda.get_device_name()``:
#: NVIDIA's data sheet for the H100 SXM (80 GB HBM3).
HBM_BANDWIDTH = {"NVIDIA H100 80GB HBM3": 3.35e12}


class RooflineAccountant:
    """Tracks kernel throughput against the card's memory roofline.

    ``bandwidth`` (bytes/s) overrides the table; otherwise ``card``
    (default: ``torch.cuda.get_device_name()``) must be one of
    :data:`HBM_BANDWIDTH`'s cards, and an unknown card raises.
    """

    def __init__(self, card: str | None = None,
                 bandwidth: float | None = None):
        if bandwidth is None:
            if card is None:
                import torch
                if not torch.cuda.is_available():
                    raise LogicError("RooflineAccountant: no CUDA card, and "
                                     "no bandwidth given")
                card = torch.cuda.get_device_name()
            if card not in HBM_BANDWIDTH:
                raise LogicError(f"RooflineAccountant: no memory rate known "
                                 f"for {card!r}; pass bandwidth=")
            bandwidth = HBM_BANDWIDTH[card]
        self.bandwidth = float(bandwidth)
        self.records: list[dict] = []

    def record(self, name: str, elements: int, bytes_per_element: float,
               seconds: float) -> dict:
        ideal = elements * bytes_per_element / self.bandwidth
        entry = {
            "kernel": name,
            "elements": elements,
            "seconds": seconds,
            "elements_per_s": elements / seconds if seconds else 0.0,
            "hbm_fraction": ideal / seconds if seconds else 0.0,
        }
        self.records.append(entry)
        return entry

    def report(self) -> list[dict]:
        return list(self.records)


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
