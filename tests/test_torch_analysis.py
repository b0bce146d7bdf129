"""Torch port, ``RiskAnalysis`` on the CPU vs the JAX package.

* ``RiskAnalysis`` (bdd, probability, importance, products) on fault-tree
  fixtures, port on ``device="cpu"`` against ``canopy_tpu`` on its CPU
  backend: probability within 1e-12 relative, every importance measure
  within 1e-10 relative, the product lists identical (probabilities
  within 1e-12 relative).
* Pre-drawn samples through both packages' CPU uncertainty evaluators
  (f64 level evaluation): within 1e-12 relative; through the port's
  stream path (the kernels' f32 plain versions): within 1e-5 relative.
* The ``golden.json`` fault-tree anchors, through the port's analysis:
  within 1e-12 relative.
* The slice model (``torch_slice_plant.xml``) with 4,096 uncertainty
  trials against ``torch_slice_golden.json``: probability 1e-12
  relative, MIF/RAW/RRW 1e-10 relative, cut-set count and module sizes
  exact.
* The uncertainty block of ``RiskAnalysis.run()``, each package on its
  own sampler (the same threefry keys), unbatched and in batches of
  1,000: ``demo_plant`` and ``station_blackout`` against the JAX package
  run here, the slice (4,096 trials) against the JAX blocks frozen in
  ``torch_prng_golden.json``: mean, std, error factor, CI, quantiles,
  histogram edges and densities within 1e-10 relative, the same trials in
  every bin.
* The branches once not ported (``test_unported_branches_raise``, its
  case ids kept): event trees (``demo_plant``'s sequences), alignment
  phases (``aralia_like_alignment``) and SIL (``aralia_like_small`` under
  ``time_step(100)``) now match the JAX report within 1e-12 relative;
  Monte Carlo runs and reports its standard error; ``"cuda"`` without a
  card raises ``DeviceError``.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.modules import build_modular_bdd as jax_modular
from canopy_tpu.compiler.modules import modular_probability as jax_mod_prob
from canopy_tpu.engine.analysis import RiskAnalysis as JaxAnalysis
from canopy_tpu.engine.propagate import mean_basic_probabilities
from canopy_tpu.mef import Initializer as JaxInitializer
from canopy_tpu.settings import Settings as JaxSettings
from canopy_tpu_torch._device import DeviceError
from canopy_tpu_torch.compiler.modules import (build_modular_bdd,
                                               modular_probability)
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.bdd_eval import make_modular_evaluator
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings

from torch_parity import (FIXTURES, fixture_path, load_tree, rel_err,
                          run_both_analyses)

with open(f"{FIXTURES}/golden.json") as fh:
    GOLDEN = json.load(fh)
with open(f"{FIXTURES}/torch_slice_golden.json") as fh:
    SLICE_GOLDEN = json.load(fh)
with open(f"{FIXTURES}/torch_prng_golden.json") as fh:
    PRNG_GOLDEN = json.load(fh)


def _configure(settings, **flags):
    settings.algorithm(flags.get("algorithm", "bdd"))
    if "approximation" in flags:
        settings.approximation(flags["approximation"])
    settings.probability_analysis(True).ccf_analysis(True)
    settings.importance_analysis(flags.get("importance", True))
    if "trials" in flags:
        settings.uncertainty_analysis(True).num_trials(flags["trials"])
        settings.seed(7)
    return settings


def _run_port(name, **flags):
    settings = _configure(Settings(), **flags)
    model = Initializer([fixture_path(name)], settings).model
    return RiskAnalysis(model, settings, "cpu").run()


def _run_jax(name, **flags):
    settings = _configure(JaxSettings(), **flags)
    model = JaxInitializer([fixture_path(name)], settings).model
    return JaxAnalysis(model, settings).run()


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("name", ["aralia_like_small",
                                  "aralia_like_substitution",
                                  "brute_noncoherent",
                                  "aralia_like_noncoherent"])
def test_analysis_matches_jax(name):
    (ours,) = _run_port(name).fault_trees
    (ref,) = _run_jax(name).fault_trees
    assert (ours.method, ours.n_products, ours.products_truncated) == \
        (ref.method, ref.n_products, ref.products_truncated)
    assert _rel(ours.probability, ref.probability) <= 1e-12
    assert [(o, lits) for o, _q, lits in ours.products] == \
        [(o, lits) for o, _q, lits in ref.products]
    for (_o, q, _l), (_o2, q2, _l2) in zip(ours.products, ref.products):
        assert _rel(q, q2) <= 1e-12
    assert [r["event"] for r in ours.importance] == \
        [r["event"] for r in ref.importance]
    for row, want in zip(ours.importance, ref.importance):
        for key in ("MIF", "CIF", "DIF", "RAW", "RRW"):
            if math.isinf(want[key]):
                assert row[key] == want[key]
            else:
                assert _rel(row[key], want[key]) <= 1e-10, (row, want)
        assert row.get("occurrence") == want.get("occurrence")


@pytest.mark.parametrize("name,tree_name", [("demo_plant", "Cooling"),
                                            ("station_blackout",
                                             "EmergencyPower")])
def test_uncertainty_evaluators_on_predrawn_samples(name, tree_name):
    _jm, jtree = load_tree("canopy_tpu", name, tree_name=tree_name)
    _tm, ttree = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    mean = mean_basic_probabilities(jtree)
    rng = np.random.default_rng(17)
    samples = np.clip(mean * rng.lognormal(0.0, 0.8, (256, len(mean))),
                      0.0, 1.0)
    want = np.asarray(jax_mod_prob(jax_modular(jtree), jnp.asarray(samples)))
    modular = build_modular_bdd(ttree)
    level = make_modular_evaluator(modular, "cpu")
    stream = make_modular_evaluator(modular, "cpu", engine="stream")
    t = torch.from_numpy(samples)
    np.testing.assert_allclose(level(t).numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(stream(t).numpy(), want, rtol=1e-5, atol=0)
    assert level.method == "bdd" and stream.method == "bdd-stream-f32"


@pytest.mark.parametrize("name", ["aralia_like_small", "aralia_like_medium",
                                  "aralia_like_large",
                                  "aralia_like_noncoherent",
                                  "aralia_like_ccf"])
def test_golden_anchors(name):
    (result,) = _run_port(name, importance=False).fault_trees
    assert _rel(result.probability,
                GOLDEN[name]["exact_probability"]) <= 1e-12


def test_slice_model_against_its_golden():
    (result,) = _run_port("torch_slice_plant", trials=4096).fault_trees
    assert _rel(result.probability,
                SLICE_GOLDEN["exact_probability"]) <= 1e-12
    assert result.n_products == SLICE_GOLDEN["n_products"]
    for row in result.importance:
        want = SLICE_GOLDEN["importance"][row["event"]]
        for key in ("MIF", "RAW", "RRW"):
            assert _rel(row[key], want[key]) <= 1e-10, (row, want)
    unc = result.uncertainty
    assert unc["n_trials"] == 4096 and "method" not in unc
    assert np.all(np.diff(unc["quantiles"]) >= 0)
    assert 0.0 < unc["ci95"][0] < unc["mean"] < unc["ci95"][1] < 1.0
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    modular = build_modular_bdd(tree)
    assert [b.n_nodes for b, _ in modular.chain] == \
        SLICE_GOLDEN["module_nodes"]
    p = torch.from_numpy(mean_basic_probabilities(tree))
    assert float(modular_probability(modular, p)) == result.probability


@pytest.mark.parametrize("case", ["event-tree", "alignment", "monte-carlo",
                                  "sil", "cuda"])
def test_unported_branches_raise(case):
    """Each case once asserted that its branch raised; the branches are
    ported, so the cases check what the branch now gives."""
    name = {"event-tree": "demo_plant",
            "alignment": "aralia_like_alignment"}.get(case,
                                                      "aralia_like_small")
    if case in ("event-tree", "alignment", "sil"):
        # Parity with the JAX report.
        def configure(settings):
            settings = _configure(settings, importance=False)
            if case == "sil":
                settings.time_step(100.0).safety_integrity_levels(True)
            return settings
        ours, ref = run_both_analyses(fixture_path(name), configure)
        if case == "event-tree":
            assert [s.sequence for s in ours.sequences] == \
                [s.sequence for s in ref.sequences] != []
            for got, want in zip(ours.sequences, ref.sequences):
                assert rel_err(got.probability, want.probability) <= 1e-12
            return
        got_rows = [(r.phase, r.probability) for r in ours.fault_trees]
        want_rows = [(r.phase, r.probability) for r in ref.fault_trees]
        assert [p for p, _ in got_rows] == [p for p, _ in want_rows]
        for (_p, got), (_p2, want) in zip(got_rows, want_rows):
            assert rel_err(got, want) <= 1e-12
        if case == "alignment":
            assert {p for p, _ in got_rows} == {None, "run", "service"}
            return
        (got,), (want,) = ours.fault_trees, ref.fault_trees
        assert got.sil["sil_level"] == want.sil["sil_level"]
        assert rel_err(got.sil["pfd_avg"], want.sil["pfd_avg"]) <= 1e-12
        for (t, v), (t2, v2) in zip(got.time_curve, want.time_curve):
            assert t == t2 and rel_err(v, v2) <= 1e-12
        return
    settings = _configure(Settings(), importance=False)
    if case == "monte-carlo":
        # Ported since (the bit-packed engine): the case now checks that
        # the branch runs and reports its estimate and standard error.
        settings.approximation("monte-carlo").num_trials(4096)
        model = Initializer([fixture_path(name)], settings).model
        (ft,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
        assert 0.0 < ft.probability < 1.0 and ft.mc_std_error > 0.0
        return
    model = Initializer([fixture_path(name)], settings).model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(DeviceError):
        RiskAnalysis(model, settings, "cuda")


def _histogram_counts(block: dict) -> list[int]:
    """The trials in each bin, from the density and the bin widths."""
    widths = np.diff(block["histogram_edges"])
    return np.rint(np.asarray(block["histogram_density"]) * widths
                   * block["n_trials"]).astype(int).tolist()


def _assert_same_uncertainty(got: dict, want: dict, what: str) -> None:
    """Summary statistics, quantiles, histogram edges and densities within
    1e-10 relative, and the same trials in every bin (a density is a count
    over the bin's width, which inherits the edges' last-bit
    differences)."""
    assert set(got) == set(want), what
    assert got["n_trials"] == want["n_trials"], what
    for key in ("mean", "std", "error_factor"):
        assert _rel(got[key], want[key]) <= 1e-10, (what, key)
    for key in ("ci95", "quantiles", "histogram_edges", "histogram_density"):
        assert len(got[key]) == len(want[key]), (what, key)
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert _rel(a, b) <= 1e-10, (what, key, i, a, b)
    assert _histogram_counts(got) == _histogram_counts(want), what


def _uncertainty_settings(settings, batch):
    settings = _configure(settings, trials=4096, importance=False)
    return settings.batch_size(batch) if batch else settings


@pytest.mark.parametrize("batch", [None, 1000])
def test_slice_uncertainty_block_matches_jax(batch):
    """The slice's uncertainty block against the JAX package's, frozen by
    ``tools/make_torch_prng_golden.py`` with these settings (the JAX run
    takes minutes on the CPU): nothing shared, nothing patched."""
    settings = _uncertainty_settings(Settings(), batch)
    model = Initializer([fixture_path("torch_slice_plant")], settings).model
    (ft,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    frozen = PRNG_GOLDEN["slice_uncertainty_4096"]
    assert frozen["n_trials"] == 4096 and frozen["seed"] == 7
    want = frozen["blocks"]["unbatched" if batch is None else
                            f"batch_{batch}"]
    _assert_same_uncertainty(ft.uncertainty, want, "torch_slice_plant")


@pytest.mark.parametrize("batch", [None, 1000])
@pytest.mark.parametrize("name", ["demo_plant", "station_blackout"])
def test_uncertainty_block_matches_jax(name, batch):
    """Each package samples its own tape under its own keys (nothing
    shared, nothing patched): the port's threefry keys are the JAX
    package's, so its uncertainty block is the JAX package's.  Batched
    runs draw batch ``b`` under ``fold_in(PRNGKey(seed), b)`` in both."""
    ours, ref = run_both_analyses(
        fixture_path(name), lambda s: _uncertainty_settings(s, batch))
    assert len(ours.fault_trees) == len(ref.fault_trees)
    n_checked = 0
    for got, want in zip(ours.fault_trees, ref.fault_trees):
        assert (got.uncertainty is None) == (want.uncertainty is None)
        if got.uncertainty is not None:
            _assert_same_uncertainty(got.uncertainty, want.uncertainty,
                                     f"{name}:{got.fault_tree}")
            n_checked += 1
    assert n_checked
