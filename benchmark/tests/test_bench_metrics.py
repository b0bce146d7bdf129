"""The end-to-end readers take the tail over every request and the rates
over the whole window; the trace's reduction unions device intervals."""

import os
import sys
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from canopy_bench import harness, roofline  # noqa: E402
from canopy_bench.trace import Trace  # noqa: E402


def run_of(records, kind="uncertainty", trace=None, window_s=None):
    return harness.Run(
        workload="w", config={"work": {"stream_flops_per_trial": 4,
                                       "n_basic": 1, "n_modules": 1,
                                       "n_sampled": 1}},
        mix={"kind": kind}, records=records,
        window_s=records[-1]["end"] if window_s is None else window_s,
        setup_s=1.5, trace=trace, counters=None, roofline=roofline)


def read(name, run):
    return harness.read_metric(BENCH, name, run)


def serve_records(latencies_ms, n_trials=1024):
    out, t = [], 0.0
    for ms in latencies_ms:
        out.append({"n_trials": n_trials, "arrival": t, "start": t,
                    "end": t + ms / 1e3})
        t += ms / 1e3
    return out


def test_p95_is_over_every_request():
    lat = list(range(1, 101))  # 1..100 ms
    run = run_of(serve_records(lat))
    assert read("request_p95_ms", run) == pytest.approx(
        float(np.quantile(lat, 0.95)))
    # One slow request among many moves the tail only as its rank says.
    lat2 = lat[:-1] + [10_000]
    assert read("request_p95_ms", run_of(serve_records(lat2))) == \
        pytest.approx(float(np.quantile(lat2, 0.95)))


def test_trial_rate_is_over_the_whole_window():
    records = serve_records([100, 300, 100])
    run = run_of(records, window_s=0.5)
    assert read("trials_per_s", run) == pytest.approx(3 * 1024 / 0.5)
    records[1]["failed"] = True
    assert read("trials_per_s", run_of(records)) == pytest.approx(
        2 * 1024 / 0.5)


def old_p95(run):
    """``request_p95_ms`` as it read before it took any kind."""
    if run.mix["kind"] != "uncertainty":
        return None
    latencies = [(r["end"] - r["arrival"]) * 1e3 for r in run.records]
    return float(np.quantile(latencies, 0.95))


def old_trial_rate(run):
    """``trials_per_s`` as it read before it took any kind."""
    if run.mix["kind"] != "uncertainty":
        return None
    trials = sum(r["n_trials"] for r in run.records if not r.get("failed"))
    return trials / run.window_s


def golden_records(seed):
    """Records of an uncertainty window as the harness writes them: sizes
    2^14..2^20, one client, a failed request among them."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for i in range(int(rng.integers(50, 400))):
        n = 1 << int(rng.integers(14, 21))
        service = float(rng.uniform(0.005, 0.045))
        out.append({"n_trials": n, "seed": int(rng.integers(1 << 31)),
                    "round_end": i % 7 == 6, "arrival": t, "start": t,
                    "end": t + service,
                    "uncertainty": {"mean": 1e-3, "n_trials": n}})
        t += service
    out[len(out) // 2] = {k: v for k, v in out[len(out) // 2].items()
                          if k != "uncertainty"} | {"failed": True}
    return out


@pytest.mark.parametrize("seed", range(6))
def test_rewritten_readers_read_the_old_floats(seed):
    records = golden_records(seed)
    run = run_of(records, window_s=records[-1]["end"] + 0.01 * seed)
    assert read("request_p95_ms", run) == old_p95(run)
    assert read("trials_per_s", run) == old_trial_rate(run)


def test_readers_take_any_kind():
    records = serve_records([10, 20, 30])
    run = run_of(records, kind="event_tree")
    assert read("request_p95_ms", run) == pytest.approx(
        float(np.quantile([10, 20, 30], 0.95)))
    assert read("trials_per_s", run) == pytest.approx(3 * 1024 / 0.06)
    for r in records:
        del r["n_trials"]
    assert read("trials_per_s", run_of(records, kind="point")) is None


def test_setup_is_read_as_measured():
    assert read("setup_s", run_of(serve_records([1, 2]))) == 1.5


def test_latency_runs_from_arrival():
    # Two clients: the second request waits for the first.
    records = [{"n_trials": 1024, "arrival": 0.0, "start": 0.0,
                "end": 0.1},
               {"n_trials": 1024, "arrival": 0.0, "start": 0.1,
                "end": 0.2}]
    assert read("request_p95_ms", run_of(records)) == pytest.approx(
        float(np.quantile([100, 200], 0.95)))


def trace_events():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [x("user_annotation", "bench.window", 0, 1_000_000),
            x("user_annotation", "bench.request.n1024", 0, 600_000),
            x("user_annotation", "bench.request.n1024", 600_000, 400_000),
            x("kernel", "void (anonymous namespace)::stream_steps_kernel"
              "<float>(int4 const*)", 100_000, 200_000),
            x("kernel", "draw_standard_kernel(long long const*)", 250_000,
              100_000),
            x("gpu_memcpy", "Memcpy DtoH", 700_000, 100_000),
            x("kernel", "outside", 2_000_000, 10),
            x("cpu_op", "aten::add", 0, 5)]


def test_trace_reduction():
    trace = Trace(trace_events())
    assert trace.window_s == pytest.approx(1.0)
    # Busy: [0.1, 0.35] and [0.7, 0.8].
    assert trace.busy_s() == pytest.approx(0.35)
    assert trace.kernel_s("stream_steps_kernel") == pytest.approx(0.2)
    assert trace.kernel_s("draw_standard_kernel") == pytest.approx(0.1)
    run = run_of(serve_records([600, 400]), trace=trace)
    assert read("device_idle_pct.serve", run) == pytest.approx(65.0)
    # Request 1: 0.6 s less 0.25 busy; request 2: 0.4 s less 0.1.
    assert read("host_ms_per_request.serve", run) == pytest.approx(325.0)
    share = read("stream_roofline.serve", run)
    assert share == pytest.approx(
        100 * 2 * roofline.stream_bound_s(run.config["work"], 1024) / 0.2)
    out = trace.breakdown()
    assert out["device_ops"][0] == ["stream_steps_kernel<float>",
                                    pytest.approx(0.2)]
    assert dict(out["idle_gaps"])["bench.request.n1024"] == \
        pytest.approx(0.65)


def test_traced_metrics_are_silent_without_a_trace():
    run = run_of(serve_records([1, 2]))
    for name in ("device_idle_pct.serve", "host_ms_per_request.serve",
                 "stream_roofline.serve", "sampler_roofline.serve"):
        assert read(name, run) is None


def test_every_metric_has_a_reader_and_applies_somewhere():
    spec = harness._load_json(os.path.dirname(BENCH), "BENCHMARK.json")
    names = [w["name"] for w in spec["workloads"]]
    for entry in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           entry["name"] + ".py"))
        assert any(harness.applies(entry, w, spec) for w in names)
    for w in names:
        e2e = [m for m in spec["end_to_end"] if harness.applies(m, w, spec)]
        layer = [m for m in spec["per_layer"] if harness.applies(m, w, spec)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert layer
        cell = harness.load_cell(w)
        assert cell["limits"]["numbers"]


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "slice_plant.serve_mc", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = types.ModuleType("fake")
    monkeypatch.setitem(sys.modules, "canopy_tpu_torch_like.x", fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "canopy_tpu.engine", fake)
    assert harness.forbidden_modules() == ["canopy_tpu"]


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's
    folder has no program to run: the command exits non-zero, silent."""
    import shutil
    import subprocess
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"),
                tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "slice_plant.serve_mc", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
