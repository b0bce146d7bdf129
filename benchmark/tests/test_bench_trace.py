"""The trace's reduction keeps the benchmark's spans and the program's,
answers every query by bisection with exactly what a scan over every span
or interval gives, names an idle gap by both spans that hold it, and
reduces a window of 20,000 spans in seconds."""

import os
import random
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import pytest  # noqa: E402

from canopy_bench import harness, roofline  # noqa: E402
from canopy_bench.trace import Trace  # noqa: E402

UA = "user_annotation"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# The scans the bisections replace, as the reduction ran them before.

def scan_busy_s(trace, start=None, end=None):
    lo = trace.window[0] if start is None else start
    hi = trace.window[1] if end is None else end
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in trace.busy) / 1e6


def scan_innermost(spans, t):
    best = None
    for n, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (n, s, e)
    return best[0] if best else None


def scan_label(trace, t):
    bench = [s for s in trace.spans
             if s[0].startswith("bench.") and s[0] != "bench.window"]
    program = [s for s in trace.spans if s[0].startswith("canopy.")]
    label = scan_innermost(bench, t) or "bench.window (between requests)"
    inner = scan_innermost(program, t)
    return f"{label}/{inner}" if inner else label


def random_events(rng, n_spans, n_device, grid):
    """Spans and device intervals at random, nested or not, on a coarse
    grid (so that ends meet and lengths tie) or at any float."""
    def t():
        return float(rng.randrange(grid)) if grid else rng.uniform(0, 1e6)
    events = [_x(UA, "bench.window", 0.0, grid or 1e6)]
    for i in range(n_spans):
        s, e = sorted((t(), t()))
        prefix = rng.choice(["bench.request.n", "canopy.uncertainty.",
                             "canopy.sample."])
        events.append(_x(UA, f"{prefix}{i}", s, e - s))
    for i in range(n_device):
        s, e = sorted((t(), t()))
        events.append(_x(rng.choice(["kernel", "gpu_memcpy"]), f"k{i}", s,
                         e - s))
    return events


@pytest.mark.parametrize("case", range(12))
def test_bisection_equals_the_scans(case):
    rng = random.Random(case)
    grid = [0, 40, 1000][case % 3]
    events = random_events(rng, n_spans=rng.randrange(1, 60),
                           n_device=rng.randrange(0, 60), grid=grid)
    trace = Trace(events)
    points = sorted({x for _n, s, e in trace.spans + trace.device
                     for x in (s, e)})
    queries = points + [(a + b) / 2 for a, b in zip(points, points[1:])] + \
        [points[0] - 1, points[-1] + 1] + \
        [rng.uniform(points[0] - 5, points[-1] + 5) for _ in range(50)]
    for t in queries:
        assert trace._label(t) == scan_label(trace, t), t
    assert trace.busy_s() == scan_busy_s(trace)
    for _ in range(200):
        a, b = sorted(rng.choice(queries) for _ in range(2))
        assert trace.busy_s(a, b) == scan_busy_s(trace, a, b)
        assert trace.host_s(a, b) == (b - a) / 1e6 - scan_busy_s(trace, a, b)


#: Microseconds: one request with the program's spans, one without.
PROGRAM = [
    _x(UA, "canopy.uncertainty", 10_000, 580_000),
    _x(UA, "canopy.uncertainty.sample", 20_000, 80_000),
    _x(UA, "canopy.sample.plan", 20_000, 20_000),
    _x(UA, "canopy.uncertainty.evaluate", 100_000, 200_000),
    _x(UA, "canopy.uncertainty.statistics", 320_000, 260_000),
    _x(UA, "canopy.uncertainty.readback", 560_000, 20_000)]
BENCH_EVENTS = [
    _x(UA, "bench.window", 0, 1_000_000),
    _x(UA, "bench.request.n1024", 0, 600_000),
    _x("kernel", "draw_standard_kernel", 50_000, 100_000),
    _x("kernel", "stream_steps_kernel", 150_000, 100_000),
    _x("gpu_memcpy", "Memcpy DtoH", 300_000, 10_000),
    _x(UA, "bench.request.n1024", 600_000, 400_000),
    _x("kernel", "stream_steps_kernel", 700_000, 100_000),
    _x("cpu_op", "aten::add", 0, 5)]


def test_program_spans_are_kept_beside_the_benchmark_spans():
    trace = Trace(BENCH_EVENTS + PROGRAM)
    assert [n for n, _s, _e in trace.named("canopy.uncertainty.")] == [
        "canopy.uncertainty.sample", "canopy.uncertainty.evaluate",
        "canopy.uncertainty.statistics", "canopy.uncertainty.readback"]
    assert len(trace.named("bench.request")) == 2
    # The sample span: 80 ms, 30 of them with the device idle.
    assert trace.host_s(20_000, 100_000) == pytest.approx(0.03)
    groups = trace.within("bench.request", "canopy.uncertainty.sample")
    assert [len(g) for g in groups] == [1, 0]


def test_idle_gaps_are_named_by_both_spans():
    trace = Trace(BENCH_EVENTS + PROGRAM)
    assert trace._label(15_000) == "bench.request.n1024/canopy.uncertainty"
    assert trace._label(30_000) == "bench.request.n1024/canopy.sample.plan"
    assert trace._label(570_000) == \
        "bench.request.n1024/canopy.uncertainty.readback"
    # No program span: the benchmark's own label, as before.
    assert trace._label(650_000) == "bench.request.n1024"
    # Each gap goes by its midpoint: [0, 50], [250, 300], [310, 700] and
    # [800, 1000] ms.
    assert dict(trace.breakdown()["idle_gaps"]) == pytest.approx({
        "bench.request.n1024/canopy.sample.plan": 0.05,
        "bench.request.n1024/canopy.uncertainty.evaluate": 0.05,
        "bench.request.n1024/canopy.uncertainty.statistics": 0.39,
        "bench.request.n1024": 0.2})


def test_gaps_between_requests_keep_their_label():
    events = [_x(UA, "bench.window", 0, 1_000_000),
              _x(UA, "bench.request.n512", 0, 400_000),
              _x(UA, "canopy.uncertainty", 0, 400_000),
              _x(UA, "bench.request.n2048", 600_000, 400_000),
              _x("kernel", "stream_steps_kernel", 0, 100_000),
              _x("kernel", "stream_steps_kernel", 150_000, 250_000),
              _x("kernel", "stream_steps_kernel", 700_000, 250_000)]
    trace = Trace(events)
    assert trace._label(500_000) == "bench.window (between requests)"
    assert dict(trace.breakdown()["idle_gaps"]) == pytest.approx({
        "bench.request.n512/canopy.uncertainty": 0.05,
        "bench.window (between requests)": 0.3,
        "bench.request.n2048": 0.05})


def run_of(trace, records, counters=None):
    return harness.Run(workload="w", config={}, mix={"kind": "uncertainty"},
                       records=records, window_s=1.0, setup_s=1.0,
                       trace=trace, counters=counters, roofline=roofline)


def read(name, run):
    return harness.read_metric(BENCH, name, run)


def test_program_span_metrics_per_request():
    run = run_of(Trace(BENCH_EVENTS + PROGRAM), [{}, {}])
    # Means over both requests; only the first holds program spans.
    assert read("stats_ms_per_request.serve", run) == pytest.approx(130.0)
    assert read("sample_host_ms_per_request.serve", run) == \
        pytest.approx(15.0)
    assert read("evaluate_host_ms_per_request.serve", run) == \
        pytest.approx(25.0)


def test_program_span_metrics_are_silent_without_program_spans():
    for trace in (None, Trace(BENCH_EVENTS)):
        run = run_of(trace, [{}, {}])
        for name in ("stats_ms_per_request.serve",
                     "sample_host_ms_per_request.serve",
                     "evaluate_host_ms_per_request.serve"):
            assert read(name, run) is None


def test_transfers_per_completed_request():
    counters = {"h2d": 18, "d2h": 4, "builds": 0}
    records = [{}, {}, {"failed": True}]
    assert read("transfers_per_request.serve",
                run_of(None, records, counters)) == 11.0
    assert read("transfers_per_request.serve",
                run_of(None, records, None)) is None


def window_of(n_requests):
    """A window shaped like the served cell's: each request a benchmark
    span, nine program spans and a dozen device operations."""
    events, t = [], 0.0
    for i in range(n_requests):
        events.append(_x(UA, "bench.request.n16384", t, 10_000))
        events.append(_x(UA, "canopy.uncertainty", t + 100, 9_800))
        for j, name in enumerate(["sample", "evaluate", "sample",
                                  "evaluate", "statistics"]):
            events.append(_x(UA, f"canopy.uncertainty.{name}",
                             t + 200 + 1_800 * j, 1_700))
        events.append(_x(UA, "canopy.sample.plan", t + 250, 600))
        events.append(_x(UA, "canopy.sample.plan", t + 3_850, 600))
        events.append(_x(UA, "canopy.uncertainty.readback", t + 9_000, 100))
        for k in range(12):
            events.append(_x("kernel", "stream_steps_kernel",
                             t + 300 + 800 * k, 300 + i % 7))
        t += 10_050.5
    return [_x(UA, "bench.window", 0, t)] + events


def test_a_window_of_20000_spans_reduces_in_seconds():
    events = window_of(2_000)
    t0 = time.perf_counter()
    trace = Trace(events)
    assert len(trace.spans) == 20_001
    run = run_of(trace, [{}] * 2_000)
    for name in ("host_ms_per_request.serve", "stats_ms_per_request.serve",
                 "sample_host_ms_per_request.serve",
                 "evaluate_host_ms_per_request.serve",
                 "device_idle_pct.serve"):
        assert read(name, run) is not None
    out = trace.breakdown()
    seconds = time.perf_counter() - t0
    assert seconds < 2.0
    assert out["idle_gaps"][0][0].startswith("bench.request.n16384/")
