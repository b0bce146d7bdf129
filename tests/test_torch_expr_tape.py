"""Torch port, expression tape: f64 means vs the JAX tape, sampler checks.

* ``evaluate_mean`` against ``canopy_tpu``'s tape on every fixture's
  basic-event expressions, on the slice model, and on a synthetic list
  that reaches every tape op (numerical, boolean, conditional, life
  distributions, both periodic tests, deviates at their means), at one
  mission time and on a time vector: within 1e-12 relative (the same
  formulas; libm and XLA may round transcendental functions differently
  in the last bit).
* Moments of every deviate kind from 200,000 draws: each sample mean
  within 5 standard errors of the distribution's mean, each sample
  variance within 5 % of its variance.
* Batch ``b`` of a run draws under ``fold_in(prng_key(seed), b)`` (the
  JAX package's rule; an unbatched run under ``prng_key(seed)``): the
  same, whatever the number of batches in the run.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from canopy_tpu.compiler.expr_tape import ExpressionTape as JaxTape
from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
from canopy_tpu_torch.ops.prng import fold_in, prng_key

from torch_parity import ALL_FIXTURES, fixture_inputs

RTOL = 1e-12


def _model(pkg, name):
    mef = importlib.import_module(f"{pkg}.mef")
    settings = importlib.import_module(f"{pkg}.settings")
    return mef.Initializer(fixture_inputs(name),
                           settings.Settings().ccf_analysis(True)).model


def _synthetic(pkg):
    """One expression per tape op, mission-time dependent so nothing
    folds on the host."""
    x = importlib.import_module(f"{pkg}.mef.expr")
    mt = importlib.import_module(f"{pkg}.mef.parameter").MissionTime()
    C = x.ConstantExpression
    t = x.Div([mt, C(8760.0)])                       # 1 at the default time.
    u = x.Add([t, C(0.25)])
    return [
        x.Exponential(C(1e-4), mt), x.Glm(C(0.1), C(1e-3), C(1e-2), mt),
        x.Weibull(C(1000.0), C(1.5), C(10.0), mt),
        x.PeriodicTest(C(1e-4), C(720.0), C(100.0), mt),
        x.PeriodicTest(C(1e-4), C(0.05), C(720.0), C(100.0), mt),
        x.Add([u, C(2.0), t]), x.Sub([u, C(0.1), C(0.2)]),
        x.Mul([u, C(3.0), u]), x.Div([C(1.0), u, C(2.0)]), x.Neg([u]),
        x.Abs([x.Neg([u])]), x.Acos([x.Div([u, C(4.0)])]),
        x.Asin([x.Div([u, C(4.0)])]), x.Atan([u]), x.Cos([u]), x.Sin([u]),
        x.Tan([u]), x.Cosh([u]), x.Sinh([u]), x.Tanh([u]), x.Exp([u]),
        x.Log([u]), x.Log10([u]), x.Mod([x.Mul([u, C(7.0)]), C(3.0)]),
        x.Pow([u, C(2.5)]), x.Sqrt([u]), x.Ceil([x.Mul([u, C(3.3)])]),
        x.Floor([x.Mul([u, C(3.3)])]), x.Min([u, C(0.5), t]),
        x.Max([u, C(0.5), t]), x.Mean([u, C(0.5), t]),
        x.Not([x.Gt([u, C(1.0)])]), x.And([x.Gt([u, C(1.0)]), C(1.0)]),
        x.Or([x.Lt([u, C(1.0)]), C(0.0)]), x.Eq([u, u]), x.Df([u, t]),
        x.Leq([u, t]), x.Geq([u, t]),
        x.Ite(x.Gt([u, C(1.0)]), u, t),
        x.Switch([(x.Lt([u, C(1.0)]), C(0.3)), (x.Gt([u, C(1.0)]), u)], t),
        x.UniformDeviate(C(1e-3), x.Mul([u, C(3e-3)])),
        x.NormalDeviate(x.Mul([u, C(1e-2)]), C(1e-3)),
        x.LognormalDeviate(x.Mul([u, C(1e-3)]), C(3.0), C(0.95)),
        x.LognormalDeviate(x.Log([x.Mul([u, C(1e-3)])]), C(0.5)),
        x.GammaDeviate(x.Mul([u, C(2.0)]), C(1e-3)),
        x.BetaDeviate(x.Mul([u, C(2.0)]), C(300.0)),
        x.Histogram([C(0.0), C(1.0), C(3.0)], [C(1.0), C(2.0)]),
    ]


def _expressions(pkg, case):
    if case == "synthetic":
        return _synthetic(pkg)
    model = _model(pkg, case)
    return [e.expression for e in model.basic_events if e.has_expression]


@pytest.mark.parametrize("case", ["synthetic"] + ALL_FIXTURES)
def test_evaluate_mean_matches_jax(case):
    ours = ExpressionTape.build(_expressions("canopy_tpu_torch", case))
    ref = JaxTape.build(_expressions("canopy_tpu", case))
    assert ours.n_outputs == ref.n_outputs and \
        ours.n_deviates == ref.n_deviates
    for mission in (8760.0, np.array([10.0, 100.0, 1000.0, 8760.0])):
        got = ours.evaluate_mean(mission, "cpu").numpy()
        want = np.asarray(ref.evaluate_mean(mission))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        assert got.dtype == np.float64


def _deviates():
    x = importlib.import_module("canopy_tpu_torch.mef.expr")
    C = x.ConstantExpression
    sigma_ef = math.log(3.0) / 1.959963984540054
    mu_ef = math.log(1e-3) - sigma_ef ** 2 / 2
    # (expression, mean, variance)
    return [
        (x.UniformDeviate(C(1.0), C(3.0)), 2.0, 4.0 / 12.0),
        (x.NormalDeviate(C(5.0), C(2.0)), 5.0, 4.0),
        (x.LognormalDeviate(C(1e-3), C(3.0), C(0.95)), 1e-3,
         (math.exp(sigma_ef ** 2) - 1) * math.exp(2 * mu_ef + sigma_ef ** 2)),
        (x.LognormalDeviate(C(-1.0), C(0.5)), math.exp(-1.0 + 0.125),
         (math.exp(0.25) - 1) * math.exp(-2.0 + 0.25)),
        (x.GammaDeviate(C(0.5), C(2.0)), 1.0, 2.0),
        (x.GammaDeviate(C(3.0), C(2.0)), 6.0, 12.0),
        (x.BetaDeviate(C(2.0), C(6.0)), 0.25, 12.0 / (64.0 * 9.0)),
        (x.Histogram([C(0.0), C(1.0), C(3.0)], [C(1.0), C(3.0)]),
         (0.5 + 3 * 2.0) / 4, (1 / 3 + 3 * 13 / 3) / 4 - (6.5 / 4) ** 2),
    ]


def test_deviate_moments():
    n = 200_000
    cases = _deviates()
    tape = ExpressionTape.build([e for e, _m, _v in cases])
    draws = tape.sample(prng_key(11), n, 8760.0, "cpu").numpy()
    for k, (expr, mean, var) in enumerate(cases):
        col = draws[:, k]
        name = type(expr).__name__
        assert abs(col.mean() - mean) <= 5 * math.sqrt(var / n), name
        assert abs(col.var() / var - 1.0) <= 0.05, name


def test_batches_depend_only_on_seed_batch_and_slot():
    tape = ExpressionTape.build([e for e, _m, _v in _deviates()])
    key = prng_key(7)
    a = tape.sample(fold_in(key, 1), 512, 8760.0, "cpu")
    assert torch.equal(a, tape.sample(fold_in(key, 1), 512, 8760.0, "cpu"))
    assert not torch.equal(a, tape.sample(fold_in(key, 2), 512, 8760.0,
                                          "cpu"))
    # Batch b of a run is the same whatever the number of batches.
    seen = []

    def top_fn(p):
        seen.append(p.clone())
        return p[:, 0]
    uncertainty_analysis(None, tape, 7, 2048, 8760.0, "cpu",
                         batch_size=512, top_fn=top_fn)
    four = list(seen)
    seen.clear()
    uncertainty_analysis(None, tape, 7, 1024, 8760.0, "cpu",
                         batch_size=512, top_fn=top_fn)
    assert len(four) == 4 and len(seen) == 2

    def clipped(k):
        return torch.clamp(tape.sample(k, 512, 8760.0, "cpu"), 0.0, 1.0)
    for b in range(2):
        assert torch.equal(four[b], seen[b])
        assert torch.equal(four[b], clipped(fold_in(key, b)))
    # An unbatched run draws under the run's key itself, as the JAX
    # package's does.
    seen.clear()
    uncertainty_analysis(None, tape, 7, 512, 8760.0, "cpu", top_fn=top_fn)
    assert torch.equal(seen[0], clipped(key))

