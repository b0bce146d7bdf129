"""The traced window: ``torch.profiler`` over the window, reduced to the
device's intervals and the benchmark's own spans.

The benchmark names its spans ``bench.<what>`` (``torch.profiler.
record_function``): ``bench.window`` around the window, ``bench.request``
or ``bench.job`` around each request or job, and inside a job
``bench.parse`` and ``bench.analysis``.  Device time is every kernel,
copy and fill the profiler's CUDA activity records; its union over the
window is the busy time.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

__all__ = ["span", "Tracer", "Trace"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    return torch.profiler.record_function(name)


def _union(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Times in microseconds on the profiler's clock."""

    def __init__(self, events: list):
        self.device = [(e["name"], e["ts"], e["ts"] + e["dur"])
                       for e in events
                       if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        self.spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") ==
                      "user_annotation" and e["name"].startswith("bench.")]
        windows = [s for s in self.spans if s[0] == "bench.window"]
        self.window = (windows[0][1], windows[0][2]) if windows else None
        lo, hi = self.window or (float("-inf"), float("inf"))
        self.busy = _union((max(s, lo), min(e, hi)) for _n, s, e in
                           self.device if e > lo and s < hi)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, start: float | None = None,
               end: float | None = None) -> float:
        """Device-busy seconds within [start, end] (the window by
        default)."""
        lo = self.window[0] if start is None else start
        hi = self.window[1] if end is None else end
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for s, e in self.busy) / 1e6

    def named(self, prefix: str) -> list:
        """Spans whose name starts with ``prefix``, in time order."""
        return sorted((s for s in self.spans if s[0].startswith(prefix)),
                      key=lambda s: s[1])

    def kernel_s(self, *names: str) -> float:
        """Seconds of device operations whose name holds any of
        ``names``, within the window."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.device
                   if any(k in n for k in names) and e > lo and s < hi) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        lo, hi = self.window
        by_name: dict[str, float] = {}
        for n, s, e in self.device:
            if e > lo and s < hi:
                key = n.replace("(anonymous namespace)::", "")
                key = key.split("(")[0].replace("void ", "").strip()
                by_name[key] = by_name.get(key, 0.0) + \
                    (min(e, hi) - max(s, lo)) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], lo
        for s, e in self.busy + [[hi, hi]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        named: dict[str, float] = {}
        for s, e in gaps:
            label = self._label((s + e) / 2)
            named[label] = named.get(label, 0.0) + (e - s) / 1e6
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}

    def _label(self, t: float) -> str:
        """The innermost benchmark span holding ``t``."""
        best = None
        for n, s, e in self.spans:
            if s <= t <= e and n != "bench.window" and \
                    (best is None or e - s < best[2] - best[1]):
                best = (n, s, e)
        return best[0] if best else "bench.window (between requests)"


class Tracer:
    """A context manager that profiles when ``enabled``; ``.trace`` holds
    the reduction afterwards."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.trace = Trace(json.load(fh)["traceEvents"])
        self._prof = None
        return False

