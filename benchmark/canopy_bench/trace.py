"""The traced window: ``torch.profiler`` over the window, reduced to the
device's intervals, the benchmark's own spans and the program's.

The benchmark names its spans ``bench.<what>`` (``torch.profiler.
record_function``): ``bench.window`` around the window, ``bench.request``
or ``bench.job`` around each request or job, and inside a job
``bench.parse`` and ``bench.analysis``.  The program names its own
``canopy.<what>`` (``canopy_tpu_torch.utils.profiling.span``), on the
same clock.  Device time is every kernel, copy and fill the profiler's
CUDA activity records; its union over the window is the busy time.

Every query bisects over intervals sorted once, so a window of some
thousand requests, each with a dozen spans, reduces in seconds; each
answer equals that of a scan over every span or interval.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time

import torch

__all__ = ["span", "Tracer", "Trace"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_PREFIXES = ("bench.", "canopy.")
_BETWEEN = "bench.window (between requests)"


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


class _Innermost:
    """The name of the innermost of ``spans`` holding a time: the
    shortest, and of equally short ones the first listed, as a scan of
    every span keeping ``start <= t <= end`` finds it.  Answers are worked
    out once for each end point and each stretch between two end points,
    by a sweep; a query bisects over the end points."""

    def __init__(self, spans: list):
        self.points = sorted({x for _n, s, e in spans for x in (s, e)})
        by_start = sorted(range(len(spans)), key=lambda i: spans[i][1])
        self.at, self.after = [], []
        heap: list = []
        k = 0
        for x in self.points:
            while k < len(by_start) and spans[by_start[k]][1] <= x:
                i = by_start[k]
                n, s, e = spans[i]
                heapq.heappush(heap, (e - s, i, e, n))
                k += 1
            # A span that ends before ``x`` holds no later time either.
            while heap and heap[0][2] < x:
                heapq.heappop(heap)
            self.at.append(heap[0][3] if heap else None)
            while heap and heap[0][2] <= x:
                heapq.heappop(heap)
            self.after.append(heap[0][3] if heap else None)

    def __call__(self, t: float) -> str | None:
        k = bisect.bisect_left(self.points, t)
        if k < len(self.points) and self.points[k] == t:
            return self.at[k]
        return self.after[k - 1] if k > 0 else None


class Trace:
    """Times in microseconds on the profiler's clock."""

    def __init__(self, events: list):
        self.device = [(e["name"], e["ts"], e["ts"] + e["dur"])
                       for e in events
                       if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        self.spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") ==
                      "user_annotation" and e["name"].startswith(_PREFIXES)]
        windows = [s for s in self.spans if s[0] == "bench.window"]
        self.window = (windows[0][1], windows[0][2]) if windows else None
        lo, hi = self.window or (float("-inf"), float("inf"))
        self.busy = _union((max(s, lo), min(e, hi)) for _n, s, e in
                           self.device if e > lo and s < hi)
        self._busy_starts = [s for s, _e in self.busy]
        self._busy_ends = [e for _s, e in self.busy]
        self._bench = _Innermost([s for s in self.spans
                                  if s[0].startswith("bench.")
                                  and s[0] != "bench.window"])
        self._program = _Innermost([s for s in self.spans
                                    if s[0].startswith("canopy.")])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, start: float | None = None,
               end: float | None = None) -> float:
        """Device-busy seconds within [start, end] (the window by
        default)."""
        lo = self.window[0] if start is None else start
        hi = self.window[1] if end is None else end
        # The merged intervals that overlap [lo, hi], summed in order: the
        # others would add 0.0, so the sum is a full scan's to the bit.
        i = bisect.bisect_right(self._busy_ends, lo)
        j = bisect.bisect_left(self._busy_starts, hi)
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for s, e in self.busy[i:j]) / 1e6

    def host_s(self, start: float, end: float) -> float:
        """Seconds of [start, end] in which the device ran nothing."""
        return (end - start) / 1e6 - self.busy_s(start, end)

    def named(self, prefix: str) -> list:
        """Spans whose name starts with ``prefix``, in time order."""
        return sorted((s for s in self.spans if s[0].startswith(prefix)),
                      key=lambda s: s[1])

    def within(self, outer: str, inner: str) -> list[list]:
        """For each span named ``outer...``, in time order, the spans
        named ``inner...`` that start inside it (inside the latest-starting
        one, where such spans overlap)."""
        outers = self.named(outer)
        starts = [s for _n, s, _e in outers]
        groups: list[list] = [[] for _ in outers]
        for got in self.named(inner):
            k = bisect.bisect_right(starts, got[1]) - 1
            if k >= 0 and got[1] <= outers[k][2]:
                groups[k].append(got)
        return groups

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
        """The innermost benchmark span holding ``t``, then ``/`` and the
        innermost program span where one holds it."""
        label = self._bench(t) or _BETWEEN
        program = self._program(t)
        return f"{label}/{program}" if program else label


class Tracer:
    """A context manager that profiles when ``enabled``; ``.trace`` holds
    the reduction afterwards, and ``.read_s`` the seconds its export and
    reading took."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self.read_s = 0.0
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
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.trace = Trace(json.load(fh)["traceEvents"])
            self.read_s = time.perf_counter() - t0
        self._prof = None
        return False
