"""A new deployment needs only new files.  A copy of the benchmark gains
a request kind of its own (the program's event-tree quantification, then
``n_trials`` outcomes drawn from it), its own plain reference over an
event-tree model that the fault-tree reference refuses, a configuration,
a mix, limits, and entries appended to ``BENCHMARK.json``; no file it
had changes.  Its cell runs through ``run_cell`` on the CPU and reports
the end-to-end metrics and ``correct``."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import pytest  # noqa: E402

from canopy_bench.reference.mef import UnsupportedModel, read_model  # noqa: E402,E501

MODEL = os.path.join(ROOT, "tests", "fixtures", "hand_event_tree.xml")
CELL = "hand_event_tree.toy_sequences"

KIND = '''"""Request kind ``toy_sequences``: the program quantifies the model's
event tree, then draws ``n_trials`` outcomes from its sequences."""

import torch

from canopy_bench import judge
from canopy_bench.reference.toy_sequences import SequenceReference

MIX_KEYS = ("log2_trials",)


def round_shapes(mix):
    return [{"n_trials": 1 << int(k)} for k in mix["log2_trials"]]


def work(request):
    return request["n_trials"]


def label(request):
    return f"bench.request.n{request['n_trials']}"


def reference(paths, device):
    return SequenceReference(paths)


class Cell:
    def __init__(self, config, mix, device, paths):
        self.config, self.device, self.paths = config, device, paths

    def setup(self):
        from canopy_tpu_torch.mef import Initializer
        from canopy_tpu_torch.settings import Settings
        self.settings = Settings().probability_analysis(True)
        self.model = Initializer(self.paths, self.settings).model

    def run(self, request):
        from canopy_tpu_torch.engine.analysis import RiskAnalysis
        report = RiskAnalysis(self.model, self.settings, self.device).run()
        names = [s.sequence for s in report.sequences]
        p = torch.tensor([s.probability for s in report.sequences],
                         dtype=torch.float64, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            request["seed"])
        drawn = torch.multinomial(p / p.sum(), request["n_trials"], True,
                                  generator=gen)
        counts = torch.bincount(drawn, minlength=len(names)).tolist()
        total = float(p.sum())
        return {**request, "sequences": {
            n: total * c / request["n_trials"]
            for n, c in zip(names, counts)}}

    def free(self):
        self.model = None

    def judge(self, records, reference, control=False):
        numbers = {}
        want = reference.sequences()
        for rec in records:
            got = want if control else rec["sequences"]
            judge.worst(numbers, "sequence_gap", max(
                judge.rel(got.get(n, float("inf")), v)
                for n, v in want.items()))
        return numbers
'''

REFERENCE = '''"""Each sequence's frequency of an event tree whose functional events
are independent fault trees of and/or gates over constant basic events,
walked with the standard library alone."""

import math
import xml.etree.ElementTree as ET


class SequenceReference:
    def __init__(self, paths):
        self.roots = [ET.parse(p).getroot() for p in paths]

    def _find(self, tag, name):
        for root in self.roots:
            for node in root.iter(tag):
                if node.get("name") == name:
                    return node
        raise KeyError(name)

    def _p(self, node):
        if node.tag == "basic-event":
            (value,) = self._find("define-basic-event", node.get("name"))
            return float(value.get("value"))
        if node.tag == "gate":
            (formula,) = self._find("define-gate", node.get("name"))
            return self._p(formula)
        if node.tag == "not":
            (child,) = node
            return 1.0 - self._p(child)
        ps = [self._p(c) for c in node]
        if node.tag == "and":
            return math.prod(ps)
        if node.tag == "or":
            return 1.0 - math.prod(1.0 - p for p in ps)
        raise ValueError(node.tag)

    def _walk(self, node, p, out):
        for child in node:
            if child.tag == "collect-formula":
                (formula,) = child
                p *= self._p(formula)
            elif child.tag == "sequence":
                out[child.get("name")] = p
            elif child.tag == "fork":
                for path in child:
                    self._walk(path, p, out)

    def sequences(self):
        out = {}
        for root in self.roots:
            for ie in root.iter("define-initiating-event"):
                tree = self._find("define-event-tree", ie.get("event-tree"))
                self._walk(tree.find("initial-state"), 1.0, out)
        return out
'''

CONFIG = {"name": "hand_event_tree",
          "mef": ["benchmark/models/hand_event_tree.xml"]}
MIX = {"kind": "toy_sequences", "loop": "closed", "clients": 1,
       "log2_trials": [12, 13], "check_requests": 3}
LIMITS = {"numbers": {"sequence_gap": 0.5}}


def new_files(bench):
    """The new deployment's files, by path under the benchmark."""
    return {"kinds/toy_sequences.py": KIND,
            "canopy_bench/reference/toy_sequences.py": REFERENCE,
            "configs/hand_event_tree.json": json.dumps(CONFIG),
            "traffic/toy_sequences.json": json.dumps(MIX),
            f"limits/{CELL}.json": json.dumps(LIMITS)}


def add_deployment(root):
    """Append the cell to a copy of ``BENCHMARK.json``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({
        "name": "hand_event_tree", "source": "tests/fixtures",
        "file": "benchmark/configs/hand_event_tree.json", "reduced": [],
        "why": "an event tree of two independent fault trees"})
    spec["workloads"].append({
        "name": CELL, "config": "hand_event_tree",
        "traffic": "toy_sequences", "chips": 1,
        "why": "event-tree quantification requests"})
    for metric in spec["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)


def test_the_fault_tree_reference_refuses_the_model():
    with pytest.raises(UnsupportedModel):
        read_model([MODEL])


def test_a_new_kind_runs_from_new_files_alone(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {os.path.relpath(os.path.join(d, f), copy)
              for d, _dirs, files in os.walk(copy) for f in files}
    for rel, text in new_files(copy).items():
        (copy / rel).write_text(text)
    shutil.copy(MODEL, copy / "models")
    add_deployment(tmp_path)
    for rel in before:
        assert filecmp.cmp(copy / rel, os.path.join(BENCH, rel),
                           shallow=False), rel

    script = (
        "import sys, time, types, torch\n"
        f"sys.path[:0] = [{str(copy)!r}, {ROOT!r}]\n"
        "from canopy_bench import harness\n"
        f"got = harness.load_cell({CELL!r})\n"
        f"args = types.SimpleNamespace(workload={CELL!r}, seed=2**31 + 9,"
        " seconds=0.5, trace=0)\n"
        "sys.exit(harness.run_cell(got, args, torch.device('cpu'),"
        " time.perf_counter()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == {"request_p95_ms", "trials_per_s",
                                      "setup_s"}
    assert result["metrics"]["trials_per_s"]["value"] > 0
    assert list(result["checks"]) == ["sequence_gap"]
    assert out.stderr.strip().splitlines()[-1].startswith(
        "check sequence_gap ")
