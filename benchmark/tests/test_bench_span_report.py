"""``span_report.py``: host time per program span and idle gaps named by
the request and the program span they fell in, computed here by hand on
a made-up trace; with no program span the gaps carry the benchmark's own
labels; the recorder takes the program's counters across the window."""

import json
import os
import sys
import time
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import pytest  # noqa: E402
import torch  # noqa: E402

import span_report  # noqa: E402
from canopy_bench import harness  # noqa: E402
from canopy_bench import trace as bench_trace  # noqa: E402


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


UA = "user_annotation"

#: Microseconds: one request with the program's spans, one without.
PROGRAM = [
    _x(UA, "canopy.uncertainty", 10_000, 580_000),
    _x(UA, "canopy.uncertainty.sample", 20_000, 80_000),
    _x(UA, "canopy.uncertainty.evaluate", 100_000, 200_000),
    _x(UA, "canopy.uncertainty.readback", 300_000, 20_000),
    _x(UA, "canopy.uncertainty.statistics", 320_000, 260_000)]
BENCH_EVENTS = [
    _x(UA, "bench.window", 0, 1_000_000),
    _x(UA, "bench.request.n1024", 0, 600_000),
    _x("kernel", "draw_standard_kernel", 50_000, 100_000),
    _x("kernel", "stream_steps_kernel", 150_000, 100_000),
    _x("gpu_memcpy", "Memcpy DtoH", 300_000, 10_000),
    _x(UA, "bench.request.n1024", 600_000, 400_000),
    _x("kernel", "stream_steps_kernel", 700_000, 100_000),
    _x("cpu_op", "aten::add", 0, 5)]


def test_host_time_and_idle_gaps_by_program_span():
    out = span_report.reduce(BENCH_EVENTS + PROGRAM)
    assert out["window_s"] == pytest.approx(1.0)
    assert out["busy_s"] == pytest.approx(0.31)
    request = "bench.request.n1024 canopy.uncertainty"
    want = {"": (580, 370), ".sample": (80, 30), ".evaluate": (200, 50),
            ".readback": (20, 10), ".statistics": (260, 260)}
    assert sorted(out["spans"]) == sorted(request + k for k in want)
    for k, (mean, host) in want.items():
        got = out["spans"][request + k]
        assert got["count"] == 1
        assert got["mean_ms"] == pytest.approx(mean)
        assert got["host_mean_ms"] == pytest.approx(host)
    assert dict(out["idle_gaps"]) == pytest.approx({
        "bench.request.n1024/canopy.uncertainty.sample": 0.05,
        "bench.request.n1024/canopy.uncertainty.evaluate": 0.05,
        "bench.request.n1024/canopy.uncertainty.statistics": 0.39,
        "bench.request.n1024": 0.2})
    # Idle inside requests 0.39 + 0.30 s, inside the child spans 0.35 s.
    assert out["idle_outside"]["request_idle_s"] == pytest.approx(0.69)
    assert out["idle_outside"]["share"] == pytest.approx(1 - 0.35 / 0.69)


def test_without_program_spans_gaps_keep_the_benchmark_labels():
    events = [_x(UA, "bench.window", 0, 1_000_000),
              _x(UA, "bench.request.n512", 0, 400_000),
              _x(UA, "bench.request.n2048", 600_000, 400_000),
              _x("kernel", "stream_steps_kernel", 0, 300_000),
              _x("kernel", "stream_steps_kernel", 700_000, 250_000)]
    out = span_report.reduce(events)
    assert out["spans"] == {}
    assert out["idle_gaps"] == \
        bench_trace.Trace(events).breakdown()["idle_gaps"]
    assert dict(out["idle_gaps"]) == pytest.approx({
        "bench.window (between requests)": 0.4,
        "bench.request.n2048": 0.05})
    assert out["idle_outside"]["share"] == pytest.approx(1.0)


def test_a_profile_trace_reads_without_the_window(tmp_path):
    """The CLI's ``--profile`` trace on the CPU: no device time, every
    span outside any request."""
    from canopy_tpu_torch.cli import main as cli_main
    model = os.path.join(ROOT, "tests", "fixtures", "demo_plant.xml")
    rc = cli_main([model, "--device", "cpu", "--uncertainty",
                   "--num-trials", "128", "--profile", str(tmp_path),
                   "-o", str(tmp_path / "report.xml")])
    assert rc == 0
    with open(tmp_path / "trace.json") as fh:
        out = span_report.reduce(json.load(fh)["traceEvents"])
    assert out["busy_s"] == 0.0
    names = {k.split()[1] for k in out["spans"]}
    assert {"canopy.analysis.total", "canopy.analysis.uncertainty",
            "canopy.uncertainty", "canopy.uncertainty.statistics"} <= names
    root = out["spans"]["- canopy.analysis.total"]
    assert root["count"] == 1
    assert root["host_mean_ms"] == pytest.approx(root["mean_ms"])
    assert out["idle_outside"]["share"] is None


def test_recorder_counts_the_window(monkeypatch, capsys):
    """A small run of the cell on the CPU, past the look for a card: the
    counters across the window hold its trials and no copy or build."""
    monkeypatch.setattr(bench_trace, "Tracer", span_report.Recorder)
    got = harness.load_cell("slice_plant.serve_mc")
    got["mix"].update({"log2_trials": [9, 10], "check_requests": 2})
    args = types.SimpleNamespace(workload="slice_plant.serve_mc",
                                 seed=2**31 + 5, seconds=0.0, trace=1)
    assert harness.run_cell(got, args, torch.device("cpu"),
                            time.perf_counter()) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] == 2
    recorder = span_report.Recorder.last
    assert recorder.trace is None  # the benchmark traces on a card only
    counted = {k: v for k, v in recorder.counters.items() if v}
    assert counted == {"trials": 512 + 1024}


def test_recorder_without_program_counters(monkeypatch):
    monkeypatch.setattr(span_report, "_counters", lambda: None)
    with span_report.Recorder(False) as recorder:
        pass
    assert recorder.counters is None
