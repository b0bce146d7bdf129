"""Torch port, the direct-propagation path of ``RiskAnalysis`` on the CPU.

* ``algorithm("pdag")`` with ``approximation("none")`` on small fixtures,
  port on ``device="cpu"`` against ``canopy_tpu`` on its CPU backend:
  probability and every importance measure within 1e-12 relative (both
  the f64 gather engine and its autodiff), the cut-set counts equal.
* The BDD blow-up branch (``build_modular_bdd`` made to raise
  ``BddBlowupError`` in both packages): the same method tag and values.
* ``make_stream_importance_fn`` on ``"cpu"`` (the f64 stream program of
  the tree and the adjoint's plain version) against gather autograd:
  MIF within 1e-12 relative to the largest.
* Uncertainty without an evaluator (``top_fn=None``: ``make_propagator``
  picks the engine) on the same pre-drawn samples in both packages: mean,
  standard deviation and quantiles within 1e-12 relative.
* The slice model under pdag against ``torch_pdag_golden.json``
  (``tools/make_torch_pdag_golden.py``): probability within 1e-12,
  MIF/RAW/RRW within 1e-10 relative, the cut-set count equal.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canopy_tpu.compiler.modules as jax_modules
import canopy_tpu.engine.uncertainty as jax_uncertainty
import canopy_tpu_torch.compiler.modules as torch_modules
import canopy_tpu_torch.engine.uncertainty as torch_uncertainty
from canopy_tpu.compiler.bdd import BddBlowupError as JaxBlowup
from canopy_tpu.engine.analysis import RiskAnalysis as JaxAnalysis
from canopy_tpu.mef import Initializer as JaxInitializer
from canopy_tpu.settings import Settings as JaxSettings
from canopy_tpu_torch.compiler.bdd import BddBlowupError
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.importance import make_stream_importance_fn
from canopy_tpu_torch.engine.propagate import top_event_probability
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils.synthetic import synthetic_mef_tree

from torch_parity import FIXTURES, fixture_path, load_tree

with open(f"{FIXTURES}/torch_pdag_golden.json") as fh:
    PDAG_GOLDEN = json.load(fh)

MEASURES = ("MIF", "CIF", "DIF", "RAW", "RRW")


def _configure(settings, algorithm="pdag", trials=None):
    settings.algorithm(algorithm).approximation("none")
    settings.probability_analysis(True).importance_analysis(True)
    settings.ccf_analysis(True)
    if trials:
        settings.uncertainty_analysis(True).num_trials(trials).seed(7)
    return settings


def _run(pkg, name, **flags):
    if pkg == "jax":
        settings = _configure(JaxSettings(), **flags)
        model = JaxInitializer([fixture_path(name)], settings).model
        return JaxAnalysis(model, settings).run().fault_trees
    settings = _configure(Settings(), **flags)
    model = Initializer([fixture_path(name)], settings).model
    return RiskAnalysis(model, settings, "cpu").run().fault_trees


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


def _assert_same(ours, ref, rtol=1e-12):
    assert (ours.method, ours.n_products) == (ref.method, ref.n_products)
    assert _rel(ours.probability, ref.probability) <= rtol
    assert [r["event"] for r in ours.importance] == \
        [r["event"] for r in ref.importance]
    for row, want in zip(ours.importance, ref.importance):
        for key in MEASURES:
            if math.isinf(want[key]):
                assert row[key] == want[key]
            else:
                assert _rel(row[key], want[key]) <= rtol, (key, row, want)


@pytest.mark.parametrize("name", ["aralia_like_small",
                                  "aralia_like_noncoherent",
                                  "aralia_like_substitution"])
def test_pdag_analysis_matches_jax(name):
    (ours,) = _run("torch", name)
    (ref,) = _run("jax", name)
    assert ours.method == "direct/direct-propagation"
    _assert_same(ours, ref)


def test_bdd_blowup_branch_matches_jax(monkeypatch):
    def blow_up(error):
        def build(*_args, **_kwargs):
            raise error("forced blow-up")
        return build
    monkeypatch.setattr(jax_modules, "build_modular_bdd",
                        blow_up(JaxBlowup))
    monkeypatch.setattr(torch_modules, "build_modular_bdd",
                        blow_up(BddBlowupError))
    (ours,) = _run("torch", "aralia_like_noncoherent", algorithm="bdd")
    (ref,) = _run("jax", "aralia_like_noncoherent", algorithm="bdd")
    assert ours.method == "bdd-fallback/direct-propagation"
    _assert_same(ours, ref)


def _synthetic_count_tree():
    top, _events = synthetic_mef_tree(n_basic=40, n_gates=30, fanin=4,
                                      seed=5, atleast_fraction=0.35,
                                      complement_fraction=0.2)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    return tree


@pytest.mark.parametrize("name", ["aralia_like_noncoherent", "demo_plant",
                                  "synthetic-count"])
def test_stream_importance_fn_matches_gather_autograd(name):
    if name == "synthetic-count":
        tree = _synthetic_count_tree()
    else:
        tree_name = "Cooling" if name == "demo_plant" else None
        _m, tree = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    house = tree.house_state_vector()
    rng = np.random.default_rng(31)
    p0 = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(0.3),
                                             tree.n_basic)))
    top_fn = make_stream_importance_fn(tree, house, "cpu")
    p = p0.clone().requires_grad_(True)
    top = top_fn(p)
    (mif,) = torch.autograd.grad(top, p)
    q = p0.clone().requires_grad_(True)
    ref = top_event_probability(tree, q, torch.as_tensor(house))
    (want,) = torch.autograd.grad(ref, q)
    assert top.dtype == torch.float64 and top.shape == ()
    assert _rel(float(top.detach()), float(ref.detach())) <= 1e-12
    scale = float(want.abs().max())
    assert float((mif - want).abs().max()) <= 1e-12 * scale
    with pytest.raises(LogicError):
        make_stream_importance_fn(tree, house, "cuda")(p0)


def test_uncertainty_without_evaluator_on_predrawn_samples(monkeypatch):
    _jm, jt = load_tree("canopy_tpu", "demo_plant", tree_name="Cooling")
    _tm, tt = load_tree("canopy_tpu_torch", "demo_plant",
                        tree_name="Cooling")
    rng = np.random.default_rng(41)
    n_trials = 500
    samples = np.clip(rng.lognormal(np.log(0.01), 0.8,
                                    (n_trials, tt.n_basic)), 0.0, 1.0)
    monkeypatch.setattr(jax_uncertainty, "sample_basic_probabilities",
                        lambda *_a, **_k: jnp.asarray(samples))
    monkeypatch.setattr(torch_uncertainty, "sample_basic_probabilities",
                        lambda *_a, **_k: torch.from_numpy(samples))
    house = np.ones(tt.n_house)
    # The tape is not read: the patched samplers return the samples.
    ref = jax_uncertainty.uncertainty_analysis(
        jt, None, None, n_trials, 8760.0, house_states=jnp.asarray(house))
    ours = torch_uncertainty.uncertainty_analysis(
        tt, None, 7, n_trials, 8760.0, "cpu", house_states=house)
    for key in ("mean", "std", "error_factor"):
        assert _rel(getattr(ours, key), getattr(ref, key)) <= 1e-12, key
    np.testing.assert_allclose(ours.quantiles, ref.quantiles, rtol=1e-12,
                               atol=0)
    default = torch_uncertainty.uncertainty_analysis(
        tt, None, 7, n_trials, 8760.0, "cpu")
    assert default.mean != ours.mean     # The tree's own house state (0).


def test_slice_model_against_its_pdag_golden():
    (result,) = _run("torch", "torch_slice_plant", trials=2048)
    assert result.method == PDAG_GOLDEN["method"]
    assert result.n_products == PDAG_GOLDEN["n_products"]
    assert _rel(result.probability, PDAG_GOLDEN["probability"]) <= 1e-12
    for row in result.importance:
        want = PDAG_GOLDEN["importance"][row["event"]]
        for key in ("MIF", "RAW", "RRW"):
            assert _rel(row[key], want[key]) <= 1e-10, (row, want)
    unc = result.uncertainty
    assert unc["n_trials"] == 2048 and "method" not in unc
    assert 0.0 < unc["ci95"][0] < unc["mean"] < unc["ci95"][1] < 1.0
