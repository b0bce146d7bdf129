"""Torch port: alignment phases, SIL and time curves.

Each case runs ``RiskAnalysis`` of both packages on the CPU over one MEF
fixture (``canopy_tpu`` on the JAX CPU backend, the port on ``"cpu"``)
and compares the reports:

* alignment phases through the batched path: ``aralia_like_alignment``
  against its golden phase values, and both fixtures with alignments
  against the JAX report (probabilities within 1e-12 relative, products
  identical, their probabilities within 1e-12 relative);
* the per-phase re-analysis with importance on: phase probabilities
  within 1e-12 relative, importance measures within 1e-10 relative (the
  tolerance of ``test_torch_analysis.py``);
* SIL and time curves under ``time_step(100)``: PFD/PFH averages, the
  SIL level, the band fractions and the curve within 1e-12 relative, on
  the BDD and the direct-propagation path, and the time curve alone.
  The slice plant is held to the JAX values frozen in
  ``torch_event_tree_golden.json`` (``sil_slice``; the JAX package takes
  about two minutes for them on a CPU).
"""

import json
import math

import pytest

from canopy_tpu_torch.cli import main as cli_main
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings

from torch_parity import FIXTURES, fixture_path, rel_err, run_both_analyses

with open(f"{FIXTURES}/golden.json") as fh:
    GOLDEN = json.load(fh)
with open(f"{FIXTURES}/torch_event_tree_golden.json") as fh:
    SIL_SLICE = json.load(fh)["sil_slice"]


def _assert_fault_trees_match(ours, ref, importance=False):
    assert len(ours.fault_trees) == len(ref.fault_trees)
    for got, want in zip(ours.fault_trees, ref.fault_trees):
        assert (got.top_event, got.alignment, got.phase, got.method,
                got.n_products, got.products_truncated) == \
            (want.top_event, want.alignment, want.phase, want.method,
             want.n_products, want.products_truncated)
        assert rel_err(got.probability, want.probability) <= 1e-12
        assert [(o, lits) for o, _q, lits in got.products] == \
            [(o, lits) for o, _q, lits in want.products]
        for (_o, q, _l), (_o2, q2, _l2) in zip(got.products, want.products):
            assert rel_err(q, q2) <= 1e-12
        assert (got.importance is None) == (not importance)
        for row, want_row in zip(got.importance or [],
                                 want.importance or []):
            assert row["event"] == want_row["event"]
            for key in ("MIF", "CIF", "DIF", "RAW", "RRW"):
                if math.isinf(want_row[key]):
                    assert row[key] == want_row[key]
                else:
                    assert rel_err(row[key], want_row[key]) <= 1e-10


@pytest.mark.parametrize("name", ["aralia_like_alignment", "demo_plant"])
def test_alignment_phases_batched(name):
    ours, ref = run_both_analyses(fixture_path(name),
                          lambda s: s.probability_analysis(True))
    _assert_fault_trees_match(ours, ref)
    assert any(r.phase for r in ours.fault_trees)
    assert "phases:" in " ".join(ours.timings)
    if name == "aralia_like_alignment":
        golden = GOLDEN[name]["phases"]
        phases = {r.phase: r.probability for r in ours.fault_trees
                  if r.alignment == "duty"}
        assert set(phases) == set(golden)
        for phase, want in golden.items():
            assert rel_err(phases[phase], want) <= 1e-12, phase


@pytest.mark.parametrize("name", ["aralia_like_alignment", "demo_plant"])
def test_alignment_phases_reanalysed_with_importance(name):
    ours, ref = run_both_analyses(
        fixture_path(name),
        lambda s: s.probability_analysis(True).importance_analysis(True))
    _assert_fault_trees_match(ours, ref, importance=True)
    assert "phases:" not in " ".join(ours.timings)
    assert sum(1 for r in ours.fault_trees if r.phase) >= 2


def _sil_settings(sil, algorithm="bdd"):
    def configure(s):
        s.algorithm(algorithm).probability_analysis(True).time_step(100.0)
        return s.safety_integrity_levels(sil)
    return configure


def _assert_sil_match(got, want):
    for key in ("pfd_avg", "pfh_avg"):
        assert rel_err(got[key], want[key]) <= 1e-12, key
    assert got["sil_level"] == want["sil_level"]
    assert got["pfd_fractions"] == want["pfd_fractions"]


@pytest.mark.parametrize("name,sil,algorithm", [
    ("aralia_like_small", True, "bdd"),
    ("aralia_like_alignment", True, "bdd"),
    ("aralia_like_alignment", False, "bdd"),
    ("aralia_like_alignment", True, "pdag"),
])
def test_sil_and_time_curves_match_jax(name, sil, algorithm):
    ours, ref = run_both_analyses(fixture_path(name),
                                  _sil_settings(sil, algorithm))
    assert len(ours.fault_trees) == len(ref.fault_trees)
    for got, want in zip(ours.fault_trees, ref.fault_trees):
        assert (got.phase, got.method) == (want.phase, want.method)
        assert len(got.time_curve) == len(want.time_curve) > 1
        for (t, v), (t2, v2) in zip(got.time_curve, want.time_curve):
            assert t == t2 and rel_err(v, v2) <= 1e-12
        assert (got.sil is None) == (not sil) == (want.sil is None)
        if sil:
            _assert_sil_match(got.sil, want.sil)


def test_sil_of_the_slice_against_frozen_jax_values():
    settings = _sil_settings(True)(Settings()).skip_products(True)
    model = Initializer([fixture_path("torch_slice_plant")], settings).model
    (result,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    _assert_sil_match(result.sil, SIL_SLICE["sil"])
    assert len(result.time_curve) == len(SIL_SLICE["time_curve"]) == 88
    for (t, v), (t2, v2) in zip(result.time_curve, SIL_SLICE["time_curve"]):
        assert t == t2 and rel_err(v, v2) <= 1e-12


def test_cli_writes_sil_and_curve(tmp_path):
    out = tmp_path / "report.xml"
    assert cli_main([fixture_path("aralia_like_alignment"), "--device",
                     "cpu", "--sil", "--time-step", "100", "--probability",
                     "-o", str(out)]) == 0
    text = out.read_text()
    assert text.count("<safety-integrity-levels") == 3  # Top and 2 phases.
    assert text.count('<curve X-title="time" Y-title="PFD">') == 3
