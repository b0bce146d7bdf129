"""The event-tree cell (``slice_event_tree.serve_seq``, request kind
``event_tree_uncertainty``): the kind runs through ``run_cell`` on the CPU
at a tiny mix and reads ``correct``; the judge sees ``correct`` false with
the evaluation broken underneath (one sequence's answer altered, half the
trials left out, the method renamed); the configuration's frozen work is
the compiled tree's; the readers read a synthetic trace and nothing
without one."""

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

from canopy_bench import harness, roofline  # noqa: E402
from canopy_bench.sequence_roofline import evaluate_bound_s  # noqa: E402
from canopy_bench.trace import Trace  # noqa: E402

CELL = "slice_event_tree.serve_seq"
TINY = {"log2_trials": [9, 10], "check_requests": 2}
READERS = ("seq_evaluate_ms_per_request.serve_seq",
           "seq_stats_ms_per_request.serve_seq",
           "seq_transfers_per_request.serve_seq",
           "seq_evaluate_roofline.serve_seq")


def load_cell() -> dict:
    return harness.load_cell(CELL, ROOT)


CONFIG = load_cell()["config"]


def run_result(capsys):
    got = load_cell()
    got["mix"].update(TINY)
    args = types.SimpleNamespace(workload=CELL, seed=2**31 + 5,
                                 seconds=0.0, trace=0)
    rc = harness.run_cell(got, args, torch.device("cpu"),
                          time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_sound_run_is_correct(capsys):
    result = run_result(capsys)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"request_p95_ms", "trials_per_s",
                                      "setup_s"}
    assert set(result["checks"]) == {"stat_gap", "method_mismatch"}
    assert result["checks"]["method_mismatch"]["value"] == 0


def _altered(trials):
    trials = dict(trials)
    trials[5] = trials[5].clone()
    trials[5][-1] = trials[5][-1] * 1.5
    return trials


def _half(trials):
    return {k: torch.cat([t[:len(t) // 2]] * 2)[:len(t)]
            for k, t in trials.items()}


FAULTS = {"answer_altered": _altered, "half_the_trials": _half,
          "method_renamed": None}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_evaluation_is_not_correct(fault, capsys, monkeypatch):
    from canopy_tpu_torch.engine import sequences
    if fault == "method_renamed":
        evaluate = sequences._evaluate_roots
        monkeypatch.setattr(sequences, "_evaluate_roots",
                            lambda *a: (evaluate(*a)[0], "bdd"))
    else:
        products = sequences._sequence_trials
        monkeypatch.setattr(sequences, "_sequence_trials",
                            lambda *a: FAULTS[fault](products(*a)))
    result = run_result(capsys)
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items()
            if c["value"] > c["limit"]]
    assert over == (["method_mismatch"] if fault == "method_renamed"
                    else ["stat_gap"])


def count_work(tree) -> dict:
    """The configuration's ``work``, counted from the compiled tree's
    level blocks as its ``derivation`` says."""
    ops, blocks = 0, 0
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            if not block.n_gates:
                continue
            blocks += 1
            n = block.arg_mask.sum(1)
            if kind == "prod":
                ops += int((n - 1).sum() + (block.arg_flip & block.arg_mask
                                            ).sum() + block.inv_out.sum())
            else:
                assert kind == "count"
                ops += int((n * (3 * block.min_num + 1)).sum())
    return {"n_basic": tree.n_basic, "n_gates": tree.n_gates,
            "n_nodes": tree.n_nodes, "n_levels": len(tree.levels),
            "n_blocks": blocks, "f64_ops_per_trial": ops}


def test_frozen_work_is_the_compiled_trees():
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.engine.event_tree_walk import walk_event_tree
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    config = CONFIG
    model = Initializer([os.path.join(ROOT, p) for p in config["mef"]],
                        Settings()).model
    (initiating,) = model.initiating_events
    outcomes = walk_event_tree(model, initiating)
    tree = compile_gates([o.conjoined_gate(f"__seq{i}__")
                          for i, o in enumerate(outcomes)])
    work = config["work"]
    assert {k: work[k] for k in count_work(tree)} == count_work(tree)
    assert work["n_sequences"] == len(outcomes) == 64
    assert work["n_sampled"] == work["n_basic"]


def traced_run(counters=None):
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [x("user_annotation", "bench.window", 0, 1_000_000)]
    for r, (start, n) in enumerate(((0, 1024), (500_000, 2048))):
        events += [
            x("user_annotation", f"bench.request.n{n}", start, 400_000),
            x("user_annotation", "canopy.event_tree", start, 400_000),
            x("user_annotation", "canopy.event_tree.evaluate",
              start + 50_000, 100_000),
            x("user_annotation", "canopy.event_tree.statistics",
              start + 150_000, 200_000 + 100_000 * r),
            x("kernel", "index_copy", start + 60_000, 40_000)]
    records = [{"n_trials": 1024, "arrival": 0.0, "start": 0.0,
                "end": 0.4},
               {"n_trials": 2048, "arrival": 0.5, "start": 0.5,
                "end": 0.9}]
    return harness.Run(workload=CELL, config=CONFIG, mix={}, records=records,
                       window_s=1.0, setup_s=1.0, trace=Trace(events),
                       counters=counters, roofline=roofline)


def read(name, run):
    return harness.read_metric(BENCH, name, run)


def test_new_readers_on_a_synthetic_trace():
    run = traced_run({"h2d": 50, "d2h": 130})
    assert read("seq_evaluate_ms_per_request.serve_seq", run) == \
        pytest.approx(100.0)
    assert read("seq_stats_ms_per_request.serve_seq", run) == \
        pytest.approx(250.0)
    assert read("seq_transfers_per_request.serve_seq", run) == 90.0
    work = run.config["work"]
    assert read("seq_evaluate_roofline.serve_seq", run) == pytest.approx(
        100 * (evaluate_bound_s(work, 1024) + evaluate_bound_s(work, 2048))
        / 0.08)
    # The bytes bound it: 8 B of each basic event and sequence a trial.
    assert evaluate_bound_s(work, 1 << 20) == pytest.approx(
        8 * (264 + 64) * 2**20 / roofline.HBM_BYTES_PER_S)


def test_new_readers_are_silent_without_a_trace_or_spans():
    run = traced_run()
    run.trace, run.counters = None, None
    for name in READERS:
        assert read(name, run) is None, name
    bare = Trace([{"ph": "X", "cat": "user_annotation",
                   "name": "bench.window", "ts": 0, "dur": 10}])
    run.trace = bare
    for name in READERS:
        assert read(name, run) is None, name
