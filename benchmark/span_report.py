"""The program's spans in a ``torch.profiler`` Chrome trace: where each
request's host time goes and what each idle gap of the device waited on.

    python3 benchmark/span_report.py TRACE.json
    python3 benchmark/span_report.py --workload slice_plant.serve_mc \\
        --seed 7 --seconds 30

The first form reads a trace written by the CLI's ``--profile DIR``
(``DIR/trace.json``) or by ``torch.profiler``'s ``export_chrome_trace``.
The second runs one cell as ``run.py --trace 1`` does (its result line
first), keeping the window's trace and the program's
``utils.profiling.counters()`` across the window; it needs the cell's
CUDA device.

Prints one JSON object:

* ``spans``: for each pair of request (the innermost ``bench.`` span,
  named as ``Trace`` names an idle gap; ``-`` in a trace without the
  benchmark's window) and ``canopy.`` span name, the count, the mean
  duration and the mean host time (the duration less the device's busy
  time inside it), in milliseconds;
* ``idle_gaps``: device-idle seconds by ``Trace``'s label of the gap's
  midpoint, followed by ``/<innermost canopy. span>`` where a program
  span holds it, largest first;
* ``idle_outside``: of the idle seconds inside ``bench.request`` spans,
  the share outside every ``canopy.uncertainty.`` span (the request's
  child spans);
* with ``--workload``, ``requests``, ``counters`` (the window's counter
  differences; null where the program has no counters) and
  ``per_request`` (each divided by the window's requests).

Device time and the benchmark's spans are ``canopy_bench.trace.Trace``'s.
Once that reduction names program spans itself, ``run.py --trace 1``
reports what this script adds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from canopy_bench import harness  # noqa: E402
from canopy_bench import trace as bench_trace  # noqa: E402

#: A request's span, and the prefix of its child spans.
REQUEST = "bench.request"
CHILDREN = "canopy.uncertainty."


def program_spans(events: list) -> list:
    """(name, start, end) of every ``canopy.`` span, in start order."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("canopy.")),
                  key=lambda s: s[1])


def _innermost(spans, t: float):
    best = None
    for n, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (n, s, e)
    return best


def _merged(spans, lo: float, hi: float) -> list:
    """The union of ``spans`` clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for _n, s, e in spans
                       if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list) -> dict:
    trace = bench_trace.Trace(events)
    program = program_spans(events)
    if trace.window is not None:
        lo, hi = trace.window
        request_of = trace._label
    else:
        times = [x for _n, s, e in program + trace.device for x in (s, e)]
        lo, hi = min(times), max(times)
        request_of = lambda _t: "-"  # noqa: E731

    def host_us(s: float, e: float) -> float:
        return (e - s) - 1e6 * trace.busy_s(s, e)

    stats: dict = {}
    for n, s, e in program:
        entry = stats.setdefault(f"{request_of((s + e) / 2)} {n}",
                                 [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += e - s
        entry[2] += host_us(s, e)
    spans = {k: {"count": c, "mean_ms": d / c / 1e3,
                 "host_mean_ms": h / c / 1e3}
             for k, (c, d, h) in sorted(stats.items())}

    named: dict = {}
    prev = lo
    for s, e in trace.busy + [[hi, hi]]:
        if s > prev:
            t = (prev + s) / 2
            inner = _innermost(program, t)
            label = request_of(t) + (f"/{inner[0]}" if inner else "")
            named[label] = named.get(label, 0.0) + (s - prev) / 1e6
        prev = max(prev, e)

    children = [x for x in program if x[0].startswith(CHILDREN)]
    request_idle = child_idle = 0.0
    for _n, s, e in trace.named(REQUEST):
        request_idle += host_us(s, e)
        child_idle += sum(host_us(a, b) for a, b in _merged(children, s, e))
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": trace.busy_s(lo, hi),
            "spans": spans,
            "idle_gaps": sorted(([k, v] for k, v in named.items()),
                                key=lambda kv: -kv[1]),
            "idle_outside": {"request_idle_s": request_idle / 1e6,
                             "share": 1.0 - child_idle / request_idle
                             if request_idle > 0 else None}}


def _counters() -> dict | None:
    """The program's counters; None where it has none."""
    try:
        from canopy_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


class KeptTrace(bench_trace.Trace):
    """The benchmark's reduction, keeping the raw events."""

    def __init__(self, events: list):
        super().__init__(events)
        self.events = events


class Recorder(bench_trace.Tracer):
    """The benchmark's tracer, also taking the program's counters just
    before and after the window; ``Recorder.last`` is the latest one."""

    last = None

    def __enter__(self):
        Recorder.last = self
        self.counters = None
        self._before = _counters()
        return super().__enter__()

    def __exit__(self, *exc):
        result = super().__exit__(*exc)
        after = _counters()
        if self._before is not None:
            self.counters = {k: v - self._before.get(k, 0)
                             for k, v in after.items()}
        return result


def serve(argv: list) -> dict | None:
    """Run one cell through the harness (``run.py``'s arguments, traced)
    and reduce its window; None if the run gave no trace."""
    # run_cell takes the tracer, and the tracer its reduction, from the
    # trace module when it runs.
    bench_trace.Trace, bench_trace.Tracer = KeptTrace, Recorder
    if harness.main(argv + ["--trace", "1"]) != 0 or \
            Recorder.last is None or Recorder.last.trace is None:
        return None
    recorder = Recorder.last
    out = reduce(recorder.trace.events)
    out["requests"] = n = len(recorder.trace.named(REQUEST))
    out["counters"] = recorder.counters
    out["per_request"] = None if recorder.counters is None else \
        {k: v / n for k, v in recorder.counters.items()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trace", nargs="?")
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seconds", type=float, default=30.0)
    args = parser.parse_args()
    if (args.trace is None) == (args.workload is None):
        parser.error("give a trace file or --workload")
    if args.trace is not None:
        with open(args.trace) as fh:
            out = reduce(json.load(fh)["traceEvents"])
    else:
        out = serve(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds)])
        if out is None:
            return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
