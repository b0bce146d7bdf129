"""Torch port, ``utils/profiling``: spans, counters and phase timers.

* One ``uncertainty_analysis`` on the slice fixture under a CPU
  ``torch.profiler`` emits the span tree the module documents, each span
  nested in its parent on the recording thread; a batched run emits one
  sample and one evaluate span per batch.
* With no profiler recording, ``span`` opens no ``record_function``.
* Counter deltas over one request: its trials, and on the CPU no
  host-device copy, no build and no launch.  ``counters()`` loads no
  kernel module, and lists every kernel's launches at 0 in a fresh
  interpreter.  The copy helpers count a copy out of
  host memory with its bytes (the meta device stands in for the card)
  and leave a copy within the host uncounted.
* ``RiskAnalysis``'s report keeps its ``<calculation-time>`` names, in
  the order the hand-written timing pairs gave them (listed here), each
  phase a ``canopy.analysis.<name up to ':'>`` span.
* The CLI's ``--profile`` trace holds the spans, each uncertainty span
  inside the whole analysis's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils import profiling
from canopy_tpu_torch.utils.profiling import (COUNTERS, PhaseTimer, counters,
                                              span, to_device, to_host)

from torch_parity import fixture_path, load_tree



@pytest.fixture(scope="module")
def slice_inputs():
    _model, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                             tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    return tree, tape


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _span_tree(prof) -> list[tuple[str, str | None]]:
    """(span, enclosing span) of every ``canopy.`` event, in start order:
    the parent is the nearest ``canopy.`` ancestor on the thread."""
    out = []
    events = sorted((e for e in prof.events()
                     if e.name.startswith("canopy.")),
                    key=lambda e: e.time_range.start)
    for event in events:
        parent = event.cpu_parent
        while parent is not None and not parent.name.startswith("canopy."):
            parent = parent.cpu_parent
        out.append((event.name, parent.name if parent else None))
    return out


@pytest.mark.parametrize("batch_size", [None, 256])
def test_uncertainty_emits_its_span_tree(slice_inputs, batch_size):
    tree, tape = slice_inputs
    _result, prof = _profiled(lambda: uncertainty_analysis(
        tree, tape, 7, 512, 8760.0, "cpu", batch_size=batch_size))
    batch = [("canopy.uncertainty.sample", "canopy.uncertainty"),
             ("canopy.sample.plan", "canopy.uncertainty.sample"),
             ("canopy.uncertainty.evaluate", "canopy.uncertainty")]
    n_batches = 1 if batch_size is None else 512 // batch_size
    assert _span_tree(prof) == \
        [("canopy.uncertainty", None)] + batch * n_batches + \
        [("canopy.uncertainty.statistics", "canopy.uncertainty"),
         ("canopy.uncertainty.readback", "canopy.uncertainty.statistics")]


def test_no_profiler_opens_no_record_function(monkeypatch, slice_inputs):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tree, tape = slice_inputs
    with span("a"), span("b"):
        pass
    uncertainty_analysis(tree, tape, 7, 64, 8760.0, "cpu")
    assert opened == []
    assert span("a") is span("b")  # the shared no-op context
    _profiled(lambda: uncertainty_analysis(tree, tape, 7, 64, 8760.0,
                                           "cpu"))
    assert opened[0] == "canopy.uncertainty" and len(opened) == 6


def test_counters_over_one_cpu_request(slice_inputs):
    tree, tape = slice_inputs
    before = counters()
    assert sorted(k for k in before if k.startswith("launch.")) == \
        sorted(k for k in COUNTERS if k.startswith("launch."))
    uncertainty_analysis(tree, tape, 7, 300, 8760.0, "cpu", batch_size=128)
    after = counters()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"trials": 300}


def test_counters_load_no_kernel_module():
    """The observability layer stands below the kernels it counts: a
    fresh interpreter reads every launch counter, each at 0, without
    loading any module of ``canopy_tpu_torch.ops``."""
    probe = ("import json, sys\n"
             "from canopy_tpu_torch.utils.profiling import counters\n"
             "snapshot = counters()\n"
             "print(json.dumps([snapshot, sorted(m for m in sys.modules if "
             "m.startswith('canopy_tpu_torch.ops'))]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], check=True, cwd=root,
                         capture_output=True, text=True, timeout=120)
    snapshot, loaded = json.loads(out.stdout)
    assert loaded == []
    assert {k: v for k, v in snapshot.items() if k.startswith("launch.")} \
        == dict.fromkeys(
            ("launch." + kernel for kernel in (
                "stream", "stream_roots", "stream_log", "adjoint",
                "fused_tiled", "fused", "replay", "replay_tape",
                "replay_bwd", "spill", "bernoulli", "gather", "block_log",
                "block_direct", "prng")), 0)


def test_copy_helpers_count_what_leaves_the_host(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", dict.fromkeys(COUNTERS, 0))
    moved = to_device([3, 4, 5], "meta", torch.int64)
    assert moved.device.type == "meta" and moved.dtype == torch.int64
    scalar = to_device(8760.0, torch.device("meta"), torch.float64)
    assert scalar.shape == ()
    assert profiling.COUNTERS["h2d"] == 2
    assert profiling.COUNTERS["h2d_bytes"] == 3 * 8 + 8
    host = torch.arange(4, dtype=torch.float32)
    assert to_device(host, "cpu") is host
    assert to_host(host) is host
    assert to_device(moved, "meta") is moved  # already there
    assert profiling.COUNTERS["h2d"] == 2
    assert profiling.COUNTERS["d2h"] == profiling.COUNTERS["d2h_bytes"] == 0


#: The report's timing names, in order, as the hand-written timing pairs
#: of ``engine/analysis.py`` gave them before ``PhaseTimer`` took over.
_KEYS = {
    "all": ["compile:cooling-failed", "bdd:cooling-failed",
            "products:cooling-failed", "probability:cooling-failed",
            "importance:cooling-failed", "uncertainty:cooling-failed",
            "walk:LOSP", "compile:LOSP", "bdd-forest:LOSP", "sampling:LOSP",
            "sequence-evaluation:LOSP", "event-tree:LOSP", "total"],
    "batched-phases": ["compile:cooling-failed", "bdd:cooling-failed",
                       "products:cooling-failed",
                       "probability:cooling-failed", "phases:cooling-failed",
                       "walk:LOSP", "compile:LOSP", "bdd-forest:LOSP",
                       "event-tree:LOSP", "total"],
    "two-trees": ["compile:cooling-failed", "bdd:cooling-failed",
                  "products:cooling-failed", "probability:cooling-failed",
                  "compile:power-failed", "bdd:power-failed",
                  "products:power-failed", "probability:power-failed",
                  "walk:LOSP", "compile:LOSP", "bdd-forest:LOSP",
                  "event-tree:LOSP", "total"],
    "preprocessor": ["total"],
}
_CASES = {
    "all": ("demo_plant", lambda s: s.probability_analysis(True)
            .importance_analysis(True).uncertainty_analysis(True)
            .num_trials(256)),
    "batched-phases": ("demo_plant", lambda s: s.probability_analysis(True)),
    "two-trees": ("hand_event_tree",
                  lambda s: s.probability_analysis(True)),
    "preprocessor": ("demo_plant", lambda s: setattr(s, "preprocessor", True)
                     or s),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_report_keeps_its_timing_names(case):
    name, configure = _CASES[case]
    settings = configure(Settings())
    model = Initializer([fixture_path(name)], settings).model
    report, prof = _profiled(
        lambda: RiskAnalysis(model, settings, "cpu").run())
    assert list(report.timings) == _KEYS[case]
    assert all(t >= 0.0 for t in report.timings.values())
    spans = {n for n, _p in _span_tree(prof) if n.startswith(
        "canopy.analysis.")}
    assert spans == {"canopy.analysis." + k.split(":")[0]
                     for k in _KEYS[case]}
    assert ("canopy.analysis.total", None) in _span_tree(prof)


def test_phase_timer_records_finished_phases_in_order():
    timer = PhaseTimer("cpu")
    with timer.phase("b:x"):
        pass
    with pytest.raises(KeyError):
        with timer.phase("raises"):
            raise KeyError
    with timer.phase("a"):
        pass
    with timer.phase("b:x"):
        pass
    assert list(timer.times) == ["b:x", "a"]
    assert timer.times["b:x"] >= 0.0 and "raises" not in timer.times


def test_span_is_a_record_function_while_a_profiler_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("a.b"):
            torch.ones(3).sum()
        assert span("a") is not span("a")
    names = [e.name for e in prof.events()]
    assert names.count("canopy.a.b") == 1


def test_profile_trace_carries_the_spans(tmp_path):
    """The CLI's ``--profile`` trace holds the analysis and uncertainty
    spans, each uncertainty span inside the whole analysis's."""
    from canopy_tpu_torch.cli import main as cli_main
    rc = cli_main([fixture_path("demo_plant"), "--device", "cpu",
                   "--uncertainty", "--num-trials", "128", "--profile",
                   str(tmp_path), "-o", str(tmp_path / "report.xml")])
    assert rc == 0
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("canopy.")]
    names = {n for n, _s, _e in spans}
    assert {"canopy.analysis.total", "canopy.analysis.uncertainty",
            "canopy.uncertainty", "canopy.uncertainty.statistics"} <= names
    (_n, lo, hi), = [x for x in spans if x[0] == "canopy.analysis.total"]
    assert all(lo <= s <= e <= hi for n, s, e in spans
               if n.startswith("canopy.uncertainty"))
