"""Torch port: event trees compiled once and quantified per request
(``engine/sequences.py``), held to the benchmark's plain reference
(``benchmark/canopy_bench/reference/event_tree.py``, imported by path; it
imports nothing of the port).

* The plant-width event tree (the slice plant and
  ``torch_event_tree_plant.xml``: 64 sequences, the BDD forest past its
  node limit, so direct propagation) at 2^10 trials, and a small
  lognormal event tree written here (k-of-n and NOT gates, basic events
  shared between systems) with the forest forced to give up: every
  sequence's mean, standard deviation, error factor and 95 % interval
  within 1e-10 relative of the reference's.
  Both compute in float64 on the same threefry draws; they differ in the
  order of a sequence's products and in the normal quantile (the port's
  threefry kernel against torch's ``erfinv``), about 1e-12 here; 1e-10
  leaves a hundred times that, and the float32 control sits near 1e-5.
* The reference evaluated in float32 is more than that tolerance off.
* ``RiskAnalysis``'s sequences equal the served call's on the same seed,
  to the bit, and requests run no walk, compile or forest.
* The reference's point values reproduce the JAX package's frozen values
  of the plant tree within 1e-12 relative (``torch_event_tree_golden``).
* A request emits its span tree and counts its sequences; the compile
  counts its forest's blow-up.
"""

import json
import os
import sys

import pytest
import torch

import canopy_tpu_torch.compiler.bdd as port_bdd
from canopy_tpu_torch.engine import sequences
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.sequences import (compile_event_tree,
                                               sequence_uncertainty)
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils import profiling

from torch_parity import FIXTURES, rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

from canopy_bench.reference.event_tree import (  # noqa: E402
    EventTreeReference)

PLANT = [os.path.join(FIXTURES, "torch_slice_plant.xml"),
         os.path.join(FIXTURES, "torch_event_tree_plant.xml")]
#: float64 against float64 (module docstring).
RTOL = 1e-10
SEED = 2**31 + 77

SMALL = """<?xml version="1.0"?>
<opsa-mef name="small-lognormal-tree">
  <define-initiating-event name="LOOP" event-tree="Response"/>
  <define-event-tree name="Response">
    <define-functional-event name="F1"/>
    <define-functional-event name="F2"/>
    <define-sequence name="OK"/>
    <define-sequence name="Late"/>
    <define-sequence name="Damage"/>
    <initial-state>
      <fork functional-event="F1">
        <path state="success">
          <collect-formula><not><gate name="g1"/></not></collect-formula>
          <fork functional-event="F2">
            <path state="success">
              <collect-formula><not><gate name="g2"/></not>
              </collect-formula>
              <sequence name="OK"/>
            </path>
            <path state="failure">
              <collect-formula><gate name="g2"/></collect-formula>
              <sequence name="Late"/>
            </path>
          </fork>
        </path>
        <path state="failure">
          <collect-formula><gate name="g1"/></collect-formula>
          <sequence name="Damage"/>
        </path>
      </fork>
    </initial-state>
  </define-event-tree>
  <define-fault-tree name="Systems">
    <define-gate name="g1"><or>
      <basic-event name="a"/><gate name="bc"/><gate name="vote"/>
    </or></define-gate>
    <define-gate name="bc"><and>
      <basic-event name="b"/><basic-event name="c"/></and></define-gate>
    <define-gate name="vote"><atleast min="2">
      <basic-event name="c"/><basic-event name="d"/><basic-event name="e"/>
    </atleast></define-gate>
    <define-gate name="g2"><and>
      <gate name="ad"/><gate name="not-b"/></and></define-gate>
    <define-gate name="ad"><or>
      <basic-event name="a"/><basic-event name="d"/></or></define-gate>
    <define-gate name="not-b"><not><basic-event name="b"/></not>
    </define-gate>
  </define-fault-tree>
  <model-data>
{events}
  </model-data>
</opsa-mef>
"""
MEANS = {"a": 0.02, "b": 0.3, "c": 0.1, "d": 0.05, "e": 0.2}


def small_xml() -> str:
    events = "\n".join(
        f'    <define-basic-event name="{n}"><lognormal-deviate>'
        f'<float value="{m}"/><float value="3"/><float value="0.95"/>'
        f'</lognormal-deviate></define-basic-event>'
        for n, m in MEANS.items())
    return SMALL.replace("{events}", events)


def _compile(paths, settings=None):
    settings = settings or Settings()
    model = Initializer(paths, settings).model
    (initiating,) = model.initiating_events
    return model, compile_event_tree(model, initiating, settings, "cpu")


@pytest.fixture(scope="module")
def plant():
    """The plant tree compiled once; its reference."""
    _model, compiled = _compile(PLANT)
    return compiled, EventTreeReference(PLANT, "cpu")


@pytest.fixture
def forced_fallback(monkeypatch):
    """The port's BDD forests give up at their first node."""
    original = port_bdd.build_bdd_multi

    def small(tree, root_slots, max_nodes=None, *args, **kwargs):
        return original(tree, root_slots, 2, *args, **kwargs)
    monkeypatch.setattr(port_bdd, "build_bdd_multi", small)


@pytest.fixture
def small_tree(tmp_path, forced_fallback):
    path = tmp_path / "small.xml"
    path.write_text(small_xml())
    return [str(path)]


def served(compiled, seed, n_trials) -> list[dict]:
    out = sequence_uncertainty(compiled, seed, n_trials)
    return [{"sequence": o.sequence.name, **out[k]}
            for k, o in enumerate(compiled.outcomes)]


def worst_gap(got: list[dict], want: list[dict]) -> float:
    assert [g["sequence"] for g in got] == [w["sequence"] for w in want]
    gaps = [0.0]
    for g, w in zip(got, want):
        assert g["n_trials"] == w["n_trials"]
        gaps += [rel_err(g[k], w[k]) if g[k] != w[k] else 0.0
                 for k in ("mean", "std", "error_factor")]
        gaps += [rel_err(a, b) for a, b in zip(g["ci95"], w["ci95"])]
    return max(gaps)


def test_plant_sequences_match_the_reference(plant):
    compiled, reference = plant
    assert compiled.root_bdds is None  # The forest gave up by itself.
    got = served(compiled, SEED, 1 << 10)
    assert len(got) == 64
    assert {g["method"] for g in got} == {"direct-propagation"}
    assert worst_gap(got, reference.sequence_uncertainty(SEED, 1 << 10)) \
        <= RTOL


def test_small_tree_matches_the_reference(small_tree):
    _model, compiled = _compile(small_tree)
    assert compiled.root_bdds is None
    reference = EventTreeReference(small_tree, "cpu")
    for seed in (SEED, 12345):
        got = served(compiled, seed, 3000)
        assert [g["sequence"] for g in got] == ["OK", "Late", "Damage"]
        assert {g["method"] for g in got} == {"direct-propagation"}
        want = reference.sequence_uncertainty(seed, 3000)
        assert worst_gap(got, want) <= RTOL


def test_float32_evaluation_fails_the_tolerance(plant):
    _compiled, reference = plant
    want = reference.sequence_uncertainty(SEED, 1 << 10)
    lower = reference.sequence_uncertainty(SEED, 1 << 10, torch.float32)
    assert worst_gap(lower, want) > 100 * RTOL


def test_risk_analysis_runs_the_served_path(plant, monkeypatch):
    compiled, _reference = plant
    settings = (Settings().uncertainty_analysis(True).num_trials(1 << 10)
                .seed(SEED).skip_products(True))
    model = Initializer(PLANT, settings).model
    (initiating,) = model.initiating_events
    report = RiskAnalysis(model, settings, "cpu")._analyze_event_tree(
        initiating)
    # Requests on the compiled tree walk, compile and build nothing.
    for name in ("walk_event_tree", "compile_gates"):
        monkeypatch.setattr(sequences, name, None)
    monkeypatch.setattr(port_bdd, "build_bdd_multi", None)
    got = sequence_uncertainty(compiled, SEED, 1 << 10)
    again = sequence_uncertainty(compiled, SEED, 1 << 10)
    assert got == again
    assert [s.uncertainty for s in report] == [got[k] for k in range(64)]
    assert [s.probability for s in report] == \
        compiled.root_values


def test_reference_point_values_match_the_golden(plant):
    _compiled, reference = plant
    with open(os.path.join(FIXTURES, "torch_event_tree_golden.json")) as fh:
        golden = json.load(fh)
    got = reference.point_values()
    assert len(got) == golden["n_sequences"] == 64
    assert len(reference.basics) == golden["n_basic"]
    for name, want in golden["sequences"].items():
        assert rel_err(got[name], want) <= 1e-12, name


def test_spans_and_counters(small_tree):
    before = profiling.counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        _model, compiled = _compile(small_tree)
        sequence_uncertainty(compiled, SEED, 256)
        sequence_uncertainty(compiled, SEED + 1, 256)
    names = [e.name for e in prof.events()
             if e.name.startswith("canopy.event_tree")]
    assert names.count("canopy.event_tree.compile") == 1
    assert names.count("canopy.event_tree.forest") == 1
    for child in ("", ".sample", ".evaluate", ".statistics"):
        assert names.count("canopy.event_tree" + child) == 2, child
    after = profiling.counters()
    # Nothing leaves the host on the CPU.
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"forest_blowups": 1,
                                          "sequences": 2 * 3}
