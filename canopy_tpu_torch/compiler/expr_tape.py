"""Expression tape compiler: MEF expression DAG -> one batched torch program.

The build half is the JAX package's (``canopy_tpu/compiler/expr_tape.py``):

* The expression DAG is flattened into a **static SSA tape** (one slot per
  unique node, deduplicated by object identity). Shared parameters are
  therefore evaluated exactly once per trial — the reference's
  memoize/reset sampling protocol (``expression.h:98-117``) holds *by
  construction*, with no mutable state.
* Pure-constant subtrees (no deviates, no mission-time dependence) are
  folded on the host at build time; everything else becomes vectorized
  f64 torch ops over an optional trials axis, on the caller's device.

Sampling replaces ``jax.random.fold_in(key, slot)`` with one
``torch.Generator`` per deviate slot on the analysis device, seeded from
``(seed, batch, slot)`` through numpy's ``SeedSequence``: deterministic,
and a batch's draws do not depend on how many batches the run has.
Gamma and beta deviates use Marsaglia-Tsang on generator-driven normals
and uniforms (torch's own gamma sampler takes no generator); histograms
draw their bins with ``torch.multinomial``.

Two evaluators are derived from one tape: ``evaluate_mean(mission_time,
device)`` -> ``(n_out,)`` means, and ``sample(key, n_trials,
mission_time, device)`` -> ``(n_trials, n_out)`` epistemic samples.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from ..errors import LogicError
from ..mef.expression import Expression
from ..mef.parameter import MissionTime, Parameter
from ..mef.expr.conditional import Ite, Switch
from ..mef.expr.constant import ConstantExpression
from ..mef.expr.exponential import PeriodicTest
from ..mef.expr.extern import ExternExpression
from ..mef.expr.random_deviate import (BetaDeviate, GammaDeviate, Histogram,
                                       LognormalDeviate, NormalDeviate,
                                       UniformDeviate)
from ..mef.expr.test_event import TestFunctionalEvent, TestInitiatingEvent

__all__ = ["ExpressionTape", "slot_generator"]

_F64 = torch.float64


# ---------------------------------------------------------------------------
# Elementwise op registry: tape_op -> torch implementation over arg tensors.
# ---------------------------------------------------------------------------

def _chain_sub(first, *rest):
    return first - sum(rest) if rest else first


def _chain_div(first, *rest):
    out = first
    for r in rest:
        out = out / r
    return out


def _flag(cond: torch.Tensor) -> torch.Tensor:
    return cond.to(_F64)


_ELEMENTWISE: dict[str, Callable] = {
    "neg": lambda x: -x,
    "add": lambda *xs: sum(xs),
    "sub": _chain_sub,
    "mul": lambda *xs: math.prod(xs),
    "div": _chain_div,
    "abs": torch.abs,
    "acos": torch.arccos,
    "asin": torch.arcsin,
    "atan": torch.arctan,
    "cos": torch.cos,
    "sin": torch.sin,
    "tan": torch.tan,
    "cosh": torch.cosh,
    "sinh": torch.sinh,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "mod": lambda x, y: torch.fmod(torch.trunc(x), torch.trunc(y)),
    "pow": torch.pow,
    "sqrt": torch.sqrt,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "min": lambda *xs: functools.reduce(torch.minimum, xs),
    "max": lambda *xs: functools.reduce(torch.maximum, xs),
    "mean": lambda *xs: sum(xs) / len(xs),
    "bnot": lambda x: _flag(x == 0),
    "band": lambda *xs: math.prod([_flag(x != 0) for x in xs]),
    "bor": lambda *xs: 1.0 - math.prod([_flag(x == 0) for x in xs]),
    "eq": lambda x, y: _flag(x == y),
    "df": lambda x, y: _flag(x != y),
    "lt": lambda x, y: _flag(x < y),
    "gt": lambda x, y: _flag(x > y),
    "leq": lambda x, y: _flag(x <= y),
    "geq": lambda x, y: _flag(x >= y),
    "exponential": lambda lam, t: -torch.expm1(-lam * t),
    "glm": lambda gamma, lam, mu, t: (
        lam - (lam - gamma * (lam + mu)) * torch.exp(-(lam + mu) * t))
        / (lam + mu),
    "weibull": lambda alpha, beta, t0, t: torch.where(
        t > t0,
        -torch.expm1(-((torch.clamp(t - t0, min=0.0) / alpha) ** beta)),
        0.0),
}


def _periodic_test_4(lam, tau, theta, time):
    delta = torch.where(time <= theta, time,
                        torch.remainder(time - theta, tau))
    return -torch.expm1(-lam * delta)


def _propagate_segment(op, lat, rep, lam, mu, dt):
    dt = torch.clamp(dt, min=0.0)
    e_l = torch.exp(-lam * dt)
    e_m = torch.exp(-mu * dt)
    denom = mu - lam
    safe = torch.abs(denom) > 1e-12 * torch.clamp(
        torch.maximum(mu, lam), min=1.0)
    general = op * e_l + mu * rep * (e_l - e_m) / torch.where(safe, denom,
                                                               1.0)
    degenerate = op * e_l + mu * rep * dt * e_l
    op_new = torch.where(safe, general, degenerate)
    rep_new = rep * e_m
    return op_new, rep_new


def _periodic_test_5(lam, mu, tau, theta, time):
    """Vectorized 3-state Markov propagation (see
    ``mef/expr/exponential.py:_instant_test``): a plain loop over test
    instants until every element has passed its mission time."""
    shape = torch.broadcast_shapes(lam.shape, mu.shape, tau.shape,
                                   theta.shape, time.shape)
    op = torch.ones(shape, dtype=_F64, device=time.device)
    rep = torch.zeros_like(op)
    t = torch.zeros_like(op)
    next_test = torch.broadcast_to(theta, shape).to(_F64).clone()
    while bool(torch.any(next_test < time)):
        active = next_test < time
        dt = torch.where(active, next_test - t, 0.0)
        op2, rep2 = _propagate_segment(op, 1.0 - op - rep, rep, lam, mu, dt)
        lat2 = 1.0 - op2 - rep2
        # Test: latent -> repair.
        rep = torch.where(active, rep2 + lat2, rep2)
        op = op2
        t = torch.where(active, next_test, t)
        next_test = torch.where(active, next_test + tau, next_test)
    op_f, _rep_f = _propagate_segment(op, 1.0 - op - rep, rep, lam, mu,
                                      time - t)
    return 1.0 - op_f


def slot_generator(key: tuple[int, ...], slot: int,
                   device: torch.device) -> torch.Generator:
    """The deviate generator of ``slot`` under ``key`` = (seed, batch)."""
    state = np.random.SeedSequence([*key, slot]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def _gamma(k: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """Gamma(k, 1) draws by Marsaglia-Tsang (boosted for k < 1)."""
    device = gen.device
    k = torch.broadcast_to(k.to(_F64), (n,))
    boost = k < 1.0
    kk = torch.where(boost, k + 1.0, k)
    d = kk - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(n, dtype=_F64, device=device)
    pending = torch.arange(n, device=device)
    while pending.numel():
        m = pending.numel()
        z = torch.randn(m, generator=gen, dtype=_F64, device=device)
        u = torch.rand(m, generator=gen, dtype=_F64, device=device)
        dp, cp = d[pending], c[pending]
        v = (1.0 + cp * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + dp - dp * v
                        + dp * torch.log(torch.clamp(v, min=1e-300)))
        out[pending[ok]] = (dp * v)[ok]
        pending = pending[~ok]
    u = torch.rand(n, generator=gen, dtype=_F64, device=device)
    return torch.where(boost, out * u ** (1.0 / k), out)


class ExpressionTape:
    """A compiled, batched evaluator for a set of output expressions."""

    def __init__(self):
        self._ops: list[tuple] = []          # (kind, out_slot, arg_slots, aux)
        self._slot_of: dict[int, int] = {}   # id(expr) -> slot
        self._n_slots = 0
        self._out_slots: list[int] = []
        self.n_deviates = 0

    # ==================================================================
    # Build.
    # ==================================================================

    @classmethod
    def build(cls, expressions: list[Expression]) -> "ExpressionTape":
        tape = cls()
        tape._out_slots = [tape._visit(e) for e in expressions]
        return tape

    @property
    def n_outputs(self) -> int:
        return len(self._out_slots)

    @staticmethod
    def _depends_on_time(expr: Expression) -> bool:
        stack = [expr]
        seen: set[int] = set()
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, MissionTime):
                return True
            stack.extend(node.args)
        return False

    def _emit(self, kind: str, arg_slots: list[int], aux=None) -> int:
        slot = self._n_slots
        self._n_slots += 1
        self._ops.append((kind, slot, arg_slots, aux))
        return slot

    def _visit(self, expr: Expression) -> int:
        key = id(expr)
        if key in self._slot_of:
            return self._slot_of[key]
        slot = self._build_node(expr)
        self._slot_of[key] = slot
        return slot

    def _build_node(self, expr: Expression) -> int:
        # Constant folding: pure deterministic subtrees evaluate on host.
        if not expr.is_deviate() and not self._depends_on_time(expr):
            return self._emit("const", [], float(expr.value()))

        if isinstance(expr, MissionTime):
            return self._emit("mission-time", [])
        if isinstance(expr, Parameter):
            return self._emit("alias", [self._visit(expr.expression)])
        if isinstance(expr, (TestInitiatingEvent, TestFunctionalEvent)):
            return self._emit("const", [], float(expr.value()))
        if isinstance(expr, ConstantExpression):
            return self._emit("const", [], float(expr.value()))
        if isinstance(expr, ExternExpression):
            raise LogicError(
                "extern-function expressions with stochastic or "
                "time-dependent arguments cannot be compiled to the "
                "expression tape; make them deterministic or evaluate on the host.")

        arg_slots = [self._visit(a) for a in expr.args]

        if isinstance(expr, UniformDeviate):
            self.n_deviates += 1
            return self._emit("uniform-deviate", arg_slots)
        if isinstance(expr, NormalDeviate):
            self.n_deviates += 1
            return self._emit("normal-deviate", arg_slots)
        if isinstance(expr, LognormalDeviate):
            self.n_deviates += 1
            return self._emit("lognormal-deviate", arg_slots, expr.flavor)
        if isinstance(expr, GammaDeviate):
            self.n_deviates += 1
            return self._emit("gamma-deviate", arg_slots)
        if isinstance(expr, BetaDeviate):
            self.n_deviates += 1
            return self._emit("beta-deviate", arg_slots)
        if isinstance(expr, Histogram):
            self.n_deviates += 1
            return self._emit("histogram", arg_slots, len(expr.weights))
        if isinstance(expr, PeriodicTest):
            return self._emit("periodic-test", arg_slots)
        if isinstance(expr, Ite):
            return self._emit("ite", arg_slots)
        if isinstance(expr, Switch):
            return self._emit("switch", arg_slots)

        tape_op = getattr(type(expr), "tape_op", None)
        if tape_op in _ELEMENTWISE:
            return self._emit(tape_op, arg_slots)
        raise LogicError(
            f"Expression type '{type(expr).__name__}' has no tape "
            "compilation rule.")

    # ==================================================================
    # Evaluate.
    # ==================================================================

    def _run(self, mission_time: torch.Tensor, key=None,
             n_trials: int | None = None):
        """Interpret the tape; sample mode iff ``key`` is given."""
        sampling = key is not None
        device = mission_time.device
        values: list = [None] * self._n_slots

        def const(x):
            return torch.as_tensor(x, dtype=_F64, device=device)

        def draw_shape():
            return (n_trials,) if sampling else ()

        def gen(slot):
            return slot_generator(key, slot, device)

        for kind, slot, arg_slots, aux in self._ops:
            a = [values[s] for s in arg_slots]
            if kind == "const":
                values[slot] = const(aux)
            elif kind == "mission-time":
                values[slot] = mission_time
            elif kind == "alias":
                values[slot] = a[0]
            elif kind == "uniform-deviate":
                lo, hi = a
                if sampling:
                    u = torch.rand(n_trials, generator=gen(slot),
                                   dtype=_F64, device=device)
                    values[slot] = lo + (hi - lo) * u
                else:
                    values[slot] = (lo + hi) / 2
            elif kind == "normal-deviate":
                mean, sigma = a
                if sampling:
                    z = torch.randn(n_trials, generator=gen(slot),
                                    dtype=_F64, device=device)
                    values[slot] = mean + sigma * z
                else:
                    values[slot] = mean
            elif kind == "lognormal-deviate":
                if aux == "normal":
                    mu, sigma = a
                    if sampling:
                        z = torch.randn(n_trials, generator=gen(slot),
                                        dtype=_F64, device=device)
                        values[slot] = torch.exp(mu + sigma * z)
                    else:
                        values[slot] = torch.exp(mu + sigma * sigma / 2)
                else:
                    mean, ef, level = a
                    z_level = torch.special.ndtri((1.0 + level) / 2.0)
                    sigma = torch.log(ef) / z_level
                    mu = torch.log(mean) - sigma * sigma / 2
                    if sampling:
                        z = torch.randn(n_trials, generator=gen(slot),
                                        dtype=_F64, device=device)
                        values[slot] = torch.exp(mu + sigma * z)
                    else:
                        values[slot] = mean
            elif kind == "gamma-deviate":
                k, theta = a
                if sampling:
                    values[slot] = _gamma(k, n_trials, gen(slot)) * theta
                else:
                    values[slot] = k * theta
            elif kind == "beta-deviate":
                alpha, beta = a
                if sampling:
                    g = gen(slot)
                    x = _gamma(alpha, n_trials, g)
                    y = _gamma(beta, n_trials, g)
                    values[slot] = x / (x + y)
                else:
                    values[slot] = alpha / (alpha + beta)
            elif kind == "histogram":
                n_bins = aux
                bounds = torch.stack([torch.broadcast_to(x, draw_shape())
                                      for x in a[:n_bins + 1]], dim=-1)
                weights = torch.stack([torch.broadcast_to(x, draw_shape())
                                       for x in a[n_bins + 1:]], dim=-1)
                mids = (bounds[..., :-1] + bounds[..., 1:]) / 2
                if sampling:
                    g = gen(slot)
                    w = torch.clamp(weights, min=0.0)
                    if all(x.ndim == 0 for x in a[n_bins + 1:]):
                        idx = torch.multinomial(w[0], n_trials,
                                                replacement=True,
                                                generator=g)
                    else:
                        idx = torch.multinomial(w, 1, generator=g)[:, 0]
                    lo = torch.gather(bounds, -1, idx[:, None])[:, 0]
                    hi = torch.gather(bounds, -1, idx[:, None] + 1)[:, 0]
                    u = torch.rand(n_trials, generator=g, dtype=_F64,
                                   device=device)
                    values[slot] = lo + (hi - lo) * u
                else:
                    total = torch.sum(weights, dim=-1)
                    values[slot] = torch.sum(weights * mids, dim=-1) / total
            elif kind == "periodic-test":
                if len(a) == 4:
                    values[slot] = _periodic_test_4(*a)
                elif len(a) == 5:
                    values[slot] = _periodic_test_5(*a)
                else:
                    # 11-arg flavor: host math is exact; deviate args are
                    # not supported on the tape yet.
                    raise LogicError(
                        "The 11-argument periodic-test with stochastic/"
                        "time-traced arguments is host-evaluated only.")
            elif kind == "ite":
                cond, then_v, else_v = a
                values[slot] = torch.where(cond != 0, then_v, else_v)
            elif kind == "switch":
                out = a[-1]
                # Build from last case to first so earlier cases win.
                pairs = list(zip(a[:-1:2], a[1:-1:2]))
                for cond, val in reversed(pairs):
                    out = torch.where(cond != 0, val, out)
                values[slot] = out
            else:
                values[slot] = _ELEMENTWISE[kind](*a)

        # Mean mode broadcasts to the mission-time shape (time-step
        # sweeps pass a vector of times); sample mode to the trials axis.
        out_shape = draw_shape() if sampling else mission_time.shape
        if not self._out_slots:
            return torch.zeros(tuple(out_shape) + (0,), dtype=_F64,
                               device=device)
        return torch.stack([torch.broadcast_to(const(values[s]), out_shape)
                            for s in self._out_slots], dim=-1)

    def evaluate_mean(self, mission_time, device) -> torch.Tensor:
        """Mean values on ``device``, shape ``mission_time.shape +
        (n_outputs,)``."""
        return self._run(torch.as_tensor(mission_time, dtype=_F64,
                                         device=torch.device(device)))

    def sample(self, key: tuple[int, ...], n_trials: int, mission_time,
               device) -> torch.Tensor:
        """Epistemic samples on ``device``, shape (n_trials, n_outputs);
        ``key`` = (seed, batch) seeds every deviate slot's generator."""
        return self._run(torch.as_tensor(mission_time, dtype=_F64,
                                         device=torch.device(device)),
                         key=tuple(int(k) for k in key), n_trials=n_trials)
