"""Torch port, exact BDD evaluation vs the JAX package.

* ``bdd_probability`` and ``modular_probability`` in f64 on every
  BDD-eligible fixture (not ``aralia_like_nested_count``: its 112k-node
  chain takes minutes under JAX on a CPU), at the mean probabilities and
  on a small sampled batch: within 1e-12 relative (the same level order;
  XLA may contract a multiply-add into one FMA, so the last bit can
  differ).  The JAX side runs under ``jax.jit``.
* Their autograd gradients against ``jax.grad``: within 1e-12 relative to
  the largest entry.
* The CPU stream path (``engine="stream"``: the kernels' plain versions)
  against ``make_modular_evaluator(..., _interpret=True, min_nodes=0)``:
  f32 within 1e-6 relative; its gradient within 1e-5 relative to the
  largest entry (f32 Shannon partials cancel where hi and lo are close).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.bdd import build_bdd as jax_build_bdd
from canopy_tpu.compiler.modules import build_modular_bdd as jax_modular
from canopy_tpu.compiler.modules import modular_probability as jax_mod_prob
from canopy_tpu.engine import bdd_eval as jbe
from canopy_tpu.engine.propagate import mean_basic_probabilities
from canopy_tpu_torch.compiler.bdd import build_bdd
from canopy_tpu_torch.compiler.modules import (build_modular_bdd,
                                               modular_probability)
from canopy_tpu_torch.engine import bdd_eval as tbe

from torch_parity import FAULT_TREE_FIXTURES, load_tree

#: (fixture, fault tree) of every fixture whose trees quantify by BDD.
BDD_CASES = [(name, None) for name in FAULT_TREE_FIXTURES
             if name != "aralia_like_nested_count"] + [
    ("demo_plant", "Cooling"), ("station_blackout", "EmergencyPower")]


def _inputs(name, tree_name):
    _jm, jtree = load_tree("canopy_tpu", name, tree_name=tree_name)
    _tm, ttree = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    mean = mean_basic_probabilities(jtree)
    rng = np.random.default_rng(len(name))
    batch = np.clip(mean * rng.lognormal(0.0, 0.5, (8, jtree.n_basic)),
                    0.0, 1.0)
    return jtree, ttree, np.vstack([mean[None, :], batch])


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name,tree_name", BDD_CASES)
def test_probabilities_and_gradients_match_jax(name, tree_name):
    jtree, ttree, p = _inputs(name, tree_name)
    jm, tm = jax_modular(jtree), build_modular_bdd(ttree)
    assert [b.n_nodes for b, _ in tm.chain] == \
        [b.n_nodes for b, _ in jm.chain]
    # Monolithic BDD (where it differs from a one-module chain).
    if len(jm.chain) > 1:
        jbdd, tbdd = jax_build_bdd(jtree), build_bdd(ttree)
        assert tbdd.n_nodes == jbdd.n_nodes
        _close(tbe.bdd_probability(tbdd, torch.from_numpy(p)).numpy(),
               jax.jit(lambda q: jbe.bdd_probability(jbdd, q))(
                   jnp.asarray(p)))
    # Modular chain, value and gradient.
    want_val, want_grad = jax.jit(jax.value_and_grad(
        lambda q: jax_mod_prob(jm, q).sum()))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    val = modular_probability(tm, tp).sum()
    (grad,) = torch.autograd.grad(val, tp)
    _close(val.item(), float(want_val))
    _close(grad.numpy(), want_grad)


@pytest.mark.parametrize("name", ["aralia_like_small",
                                  "aralia_like_noncoherent"])
def test_cpu_stream_path_matches_jax_interpret(name):
    jtree, ttree, _p = _inputs(name, None)
    values = np.random.default_rng(5).uniform(
        0.0, 0.3, (1024, jtree.n_basic)).astype(np.float32)
    want = jbe.make_modular_evaluator(jax_modular(jtree), _interpret=True,
                                      min_nodes=0)(jnp.asarray(values))
    ev = tbe.make_modular_evaluator(build_modular_bdd(ttree), "cpu",
                                    engine="stream")
    assert ev.method == "bdd-stream-f32"
    np.testing.assert_allclose(ev(torch.from_numpy(values)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=0)


def test_bdd_evaluator_stream_path_matches_jax_interpret():
    """The monolithic-BDD evaluator, value and gradient, on the stream
    path of both packages."""
    jtree, ttree, _p = _inputs("aralia_like_small", None)
    values = np.random.default_rng(8).uniform(
        0.0, 0.3, (1024, jtree.n_basic)).astype(np.float32)
    jev = jbe.make_bdd_evaluator(jax_build_bdd(jtree), engine="stream",
                                 _interpret=True, differentiable=True)
    want_val, want_grad = jax.value_and_grad(lambda v: jev(v).sum())(
        jnp.asarray(values))
    ev = tbe.make_bdd_evaluator(build_bdd(ttree), "cpu", engine="stream",
                                differentiable=True)
    assert ev.method == jev.method == "bdd-stream-f32"
    tv = torch.from_numpy(values).requires_grad_(True)
    val = ev(tv).sum()
    val.backward()
    _close(val.item(), float(want_val), rtol=1e-6)
    _close(tv.grad.numpy(), want_grad, rtol=1e-5)


def test_cpu_stream_gradient_matches_jax_adjoint():
    jtree, ttree, _p = _inputs("aralia_like_small", None)
    values = np.random.default_rng(6).uniform(
        0.0, 0.3, (1024, jtree.n_basic)).astype(np.float32)
    jev = jbe.make_modular_evaluator(jax_modular(jtree), _interpret=True,
                                     min_nodes=0, differentiable=True)
    want = jax.grad(lambda v: jev(v).sum())(jnp.asarray(values))
    ev = tbe.make_modular_evaluator(build_modular_bdd(ttree), "cpu",
                                    engine="stream", differentiable=True)
    tv = torch.from_numpy(values).requires_grad_(True)
    ev(tv).sum().backward()
    _close(tv.grad.numpy(), want, rtol=1e-5)


def test_f64_stream_path_is_the_level_evaluation():
    """``dtype=float64`` runs the kernels' arithmetic in f64 (the path
    importance takes on CUDA): it agrees with the f64 level evaluation
    and names its precision."""
    _jm, ttree = load_tree("canopy_tpu_torch", "aralia_like_medium")
    modular = build_modular_bdd(ttree)
    p = torch.from_numpy(mean_basic_probabilities(ttree))
    ev = tbe.make_modular_evaluator(modular, "cpu", engine="stream",
                                    differentiable=True,
                                    dtype=torch.float64)
    assert ev.method == "bdd-stream-f64"
    q = p.clone().requires_grad_(True)
    got = ev(q[None, :])[0]
    (grad,) = torch.autograd.grad(got, q)
    r = p.clone().requires_grad_(True)
    want = modular_probability(modular, r)
    (want_grad,) = torch.autograd.grad(want, r)
    _close(got.item(), want.item())
    _close(grad.numpy(), want_grad.numpy())


def test_stream_path_ignores_the_tpu_scheduler_caps(monkeypatch):
    """The shared scheduler's VMEM-pool and unrolled-edge caps belong to
    the TPU kernel.  A module that scheduler rejects still takes the
    stream path here, never the level evaluation."""
    from canopy_tpu_torch.compiler import schedule
    from canopy_tpu_torch.errors import LogicError
    monkeypatch.setattr(schedule, "_MAX_EDGES", 10)
    monkeypatch.setattr(schedule, "_VMEM_BUDGET", 0)
    _jm, ttree = load_tree("canopy_tpu_torch", "aralia_like_medium")
    modular = build_modular_bdd(ttree)
    bdd = max(modular.chain, key=lambda c: c[0].n_nodes)[0]
    with pytest.raises(LogicError):
        schedule.build_bdd_stream_schedule(bdd)
    ev = tbe.make_modular_evaluator(modular, "cpu", engine="stream",
                                    dtype=torch.float64)
    assert ev.method == "bdd-stream-f64"
    p = torch.from_numpy(_inputs("aralia_like_medium", None)[2])
    _close(ev(p).numpy(), modular_probability(modular, p).numpy())


def test_level_evaluation_on_cpu_is_not_the_stream_path():
    _jm, ttree = load_tree("canopy_tpu_torch", "aralia_like_small")
    ev = tbe.make_modular_evaluator(build_modular_bdd(ttree), "cpu")
    assert ev.method == "bdd"
