"""``correct`` fails where it must.  The control (the reference in the
precision below the configuration's, in the program's place) reads above
every cell's limits; and a run driven past the look for a card, on the
CPU at a small size, with the timed path broken underneath, comes out
``correct: false`` for each fault the cell can have: a step that leaves
its state unchanged, half of the batch left out, an answer altered where
it is produced.  One run on the card (skipped without one)."""

import json
import os
import subprocess
import sys
import time
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import pytest  # noqa: E402
import torch  # noqa: E402

from canopy_bench import harness  # noqa: E402
from canopy_bench.cells import (  # noqa: E402
    load_kind, make_cell, make_reference)

#: A small load for the CPU: the cell's mix with small requests.
SMALL = {"log2_trials": [9, 10], "check_requests": 2}
CELLS = [w["name"] for w in
         harness._load_json(ROOT, "BENCHMARK.json")["workloads"]]


def small_cell(workload):
    got = harness.load_cell(workload)
    got["mix"].update(SMALL)
    return got


def over_limits(numbers, limits):
    return [k for k, v in limits.items() if numbers.get(k, 0.0) > v]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    got = small_cell(workload)
    kind = load_kind(got["bench"], got["mix"]["kind"])
    cell = make_cell(got["config"], got["mix"], torch.device("cpu"),
                     harness.ROOT, kind)
    reference = make_reference(kind, cell.paths, "cpu")
    records = [{"n_trials": 1 << 12, "seed": 2**31 + 1}]
    numbers = cell.judge(records, reference, control=True)
    assert over_limits(numbers, got["limits"]["numbers"]), numbers


def run_result(workload, capsys):
    got = small_cell(workload)
    args = types.SimpleNamespace(workload=workload, seed=2**31 + 3,
                                 seconds=0.0, trace=0)
    rc = harness.run_cell(got, args, torch.device("cpu"),
                          time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _unchanged(tops):
    return torch.zeros_like(tops)


def _half(tops):
    half = tops[:len(tops) // 2]
    return torch.cat([half, half])[:len(tops)]


def _altered(tops):
    tops = tops.clone()
    tops[-1] = tops[-1] * 1.5
    return tops


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half,
          "answer_altered": _altered}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_serve_run_fails_on_a_broken_evaluator(fault, capsys, monkeypatch):
    from canopy_tpu_torch.engine import bdd_eval
    make = bdd_eval.make_modular_evaluator

    def broken(*args, **kwargs):
        fn = make(*args, **kwargs)
        return lambda p: FAULTS[fault](fn(p))
    monkeypatch.setattr(bdd_eval, "make_modular_evaluator", broken)
    result = run_result("slice_plant.serve_mc", capsys)
    assert result["correct"] is False
    assert list(result)[-1] == "checks"


def test_sound_run_is_correct(capsys):
    result = run_result("slice_plant.serve_mc", capsys)
    assert result["correct"] is True
    assert set(result["checks"]) == {"stat_gap", "hist_moved"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "slice_plant.serve_mc", "--seed", str(2**31 + 11), "--seconds",
         "2", "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
