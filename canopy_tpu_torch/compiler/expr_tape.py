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

Sampling keys as the JAX tape keys: deviate slot ``s`` draws under
``fold_in(key, s)``, through ``ops/prng.py``'s threefry counterparts of
``jax.random``, so the same key gives the JAX tape's samples (integers and
uniforms bit for bit, the transcendental transforms within a few ulps).
The uniform, normal and lognormal deviates depend only on the key and the
slot: one ``draw_standard`` launch draws them all (applying ``lo + (hi -
lo) * u``, ``mean + sigma * z`` or ``exp(mu + sigma * z)`` in the kernel
where the parameters are fixed, straight into the output columns), with
the Gumbel noise and uniforms of every histogram.  Gamma and beta
deviates draw in tape order, one ``draw_gamma`` launch each, because
their parameters may themselves be sampled.

Two evaluators are derived from one tape: ``evaluate_mean(mission_time,
device)`` -> ``(n_out,)`` means, and ``sample(key, n_trials,
mission_time, device)`` -> ``(n_trials, n_out)`` epistemic samples.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

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
from ..ops.prng import (AFFINE, EXP_AFFINE, GUMBEL, NONE, NORMAL, UNIFORM,
                        StandardTable, beta_from_logs, draw_gamma,
                        draw_standard, fold_in_many, split)
from ..utils.profiling import span, to_device, to_host

__all__ = ["ExpressionTape"]

_F64 = torch.float64
_STANDARD = ("uniform-deviate", "normal-deviate", "lognormal-deviate")
_DEVIATES = _STANDARD + ("gamma-deviate", "beta-deviate", "histogram")


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


class ExpressionTape:
    """A compiled, batched evaluator for a set of output expressions."""

    def __init__(self):
        self._ops: list[tuple] = []          # (kind, out_slot, arg_slots, aux)
        self._slot_of: dict[int, int] = {}   # id(expr) -> slot
        self._n_slots = 0
        self._out_slots: list[int] = []
        self.n_deviates = 0
        self._varying_cache: list[bool] | None = None
        self._plan: dict | None = None

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

    def _evaluate(self, kind: str, aux, a: list, mission_time, const):
        """One non-deviate op on its argument values."""
        if kind == "const":
            return const(aux)
        if kind == "mission-time":
            return mission_time
        if kind == "alias":
            return a[0]
        if kind == "periodic-test":
            if len(a) == 4:
                return _periodic_test_4(*a)
            if len(a) == 5:
                return _periodic_test_5(*a)
            # 11-arg flavor: host math is exact; deviate args are not
            # supported on the tape yet.
            raise LogicError(
                "The 11-argument periodic-test with stochastic/"
                "time-traced arguments is host-evaluated only.")
        if kind == "ite":
            cond, then_v, else_v = a
            return torch.where(cond != 0, then_v, else_v)
        if kind == "switch":
            out = a[-1]
            # Build from last case to first so earlier cases win.
            pairs = list(zip(a[:-1:2], a[1:-1:2]))
            for cond, val in reversed(pairs):
                out = torch.where(cond != 0, val, out)
            return out
        return _ELEMENTWISE[kind](*a)

    @staticmethod
    def _deviate_mean(kind: str, aux, a: list):
        if kind == "uniform-deviate":
            lo, hi = a
            return (lo + hi) / 2
        if kind == "normal-deviate":
            return a[0]
        if kind == "lognormal-deviate":
            if aux == "normal":
                mu, sigma = a
                return torch.exp(mu + sigma * sigma / 2)
            return a[0]
        if kind == "gamma-deviate":
            k, theta = a
            return k * theta
        if kind == "beta-deviate":
            alpha, beta = a
            return alpha / (alpha + beta)
        # Histogram: the weighted mean of the bins' midpoints.
        n_bins = aux
        bounds = torch.stack(list(torch.broadcast_tensors(*a[:n_bins + 1])),
                             dim=-1)
        weights = torch.stack(list(torch.broadcast_tensors(
            *a[n_bins + 1:])), dim=-1)
        mids = (bounds[..., :-1] + bounds[..., 1:]) / 2
        return torch.sum(weights * mids, dim=-1) / torch.sum(weights, dim=-1)

    def _run_mean(self, mission_time: torch.Tensor) -> torch.Tensor:
        device = mission_time.device
        values: list = [None] * self._n_slots

        def const(x):
            return torch.as_tensor(x, dtype=_F64, device=device)

        for kind, slot, arg_slots, aux in self._ops:
            a = [values[s] for s in arg_slots]
            if kind in _DEVIATES:
                values[slot] = self._deviate_mean(kind, aux, a)
            else:
                values[slot] = self._evaluate(kind, aux, a, mission_time,
                                              const)
        # Time-step sweeps pass a vector of times: broadcast to its shape.
        return self._stack(values, mission_time.shape, device)

    def _stack(self, values: list, shape, device) -> torch.Tensor:
        if not self._out_slots:
            return torch.zeros(tuple(shape) + (0,), dtype=_F64,
                               device=device)
        return torch.stack([torch.broadcast_to(torch.as_tensor(
            values[s], dtype=_F64, device=device), shape)
            for s in self._out_slots], dim=-1)

    # ==================================================================
    # Sample.
    # ==================================================================

    def _varying(self) -> list[bool]:
        """Per slot: whether a deviate reaches it (its value differs by
        trial)."""
        if self._varying_cache is None:
            varying = [False] * self._n_slots
            for kind, slot, arg_slots, _aux in self._ops:
                varying[slot] = kind in _DEVIATES or any(
                    varying[s] for s in arg_slots)
            self._varying_cache = varying
        return self._varying_cache

    def _root(self, slot: int) -> int:
        """The slot an alias chain ends at."""
        while self._ops[slot][0] == "alias":
            slot = self._ops[slot][2][0]
        return slot

    @staticmethod
    def _lognormal_params(aux, a: list):
        """``(mu, sigma)`` of a lognormal deviate (its error-factor flavor
        converted as the JAX tape converts it)."""
        if aux == "normal":
            return a[0], a[1]
        mean, ef, level = a
        z_level = torch.special.ndtri((1.0 + level) / 2.0)
        sigma = torch.log(ef) / z_level
        return torch.log(mean) - sigma * sigma / 2, sigma

    def _standard_params(self, kind: str, aux, a: list):
        """``(transform, p0, p1)`` of a uniform, normal or lognormal
        deviate: ``lo + (hi - lo) * u``, ``mean + sigma * z``, ``exp(mu +
        sigma * z)``."""
        if kind == "uniform-deviate":
            lo, hi = a
            return AFFINE, lo, hi - lo
        if kind == "normal-deviate":
            return AFFINE, a[0], a[1]
        mu, sigma = self._lognormal_params(aux, a)
        return EXP_AFFINE, mu, sigma

    def _sample_plan(self, t_host: torch.Tensor) -> dict:
        """What a sample at this mission time draws, keys aside: the
        ``draw_standard`` rows, the columns of the block, and the host
        values device operations read.  It depends on the mission time
        alone, so the last one is kept."""
        if self._plan is not None and self._plan["mission_time"] == \
                float(t_host):
            return self._plan
        varying = self._varying()

        # Every slot no deviate reaches, as a host scalar: the standard
        # deviates' parameters come from here.
        host: list = [None] * self._n_slots

        def host_const(x):
            return torch.as_tensor(x, dtype=_F64)

        for kind, slot, arg_slots, aux in self._ops:
            if not varying[slot]:
                host[slot] = self._evaluate(
                    kind, aux, [host[s] for s in arg_slots], t_host,
                    host_const)

        # The rows: the uniform, normal and lognormal deviates (transformed
        # in the kernel where their parameters are fixed, each into its
        # output columns), and the Gumbel noise and uniforms of
        # histograms.  A row's key is its slot's (source 0) or one of the
        # two halves of its slot's split (sources 1 and 2).
        out_cols: dict[int, list[int]] = {}
        for j, s in enumerate(self._out_slots):
            out_cols.setdefault(self._root(s), []).append(j)
        rows = []
        col_of: dict[int, int] = {}    # slot -> its final values' column
        raw_of: dict[int, int] = {}    # slot -> its standard draw's column
        hist_of: dict[int, tuple[int, int]] = {}
        n_cols = len(self._out_slots)
        fixed: dict[tuple, list] = {}  # (kind, aux) -> [(slot, cols)]
        for kind, slot, arg_slots, aux in self._ops:
            if kind == "histogram":
                hist_of[slot] = (n_cols, n_cols + aux)
                rows += [(1, slot, GUMBEL, NONE, aux, b, n_cols + b, 0.0, 0.0)
                         for b in range(aux)]
                rows.append((2, slot, UNIFORM, NONE, 1, 0, n_cols + aux, 0.0,
                             0.0))
                n_cols += aux + 1
            elif kind in _STANDARD:
                draw = UNIFORM if kind == "uniform-deviate" else NORMAL
                if any(varying[s] for s in arg_slots):
                    rows.append((0, slot, draw, NONE, 1, 0, n_cols, 0.0, 0.0))
                    raw_of[slot] = n_cols
                    n_cols += 1
                    continue
                cols = out_cols.get(slot)
                if cols is None:
                    cols = [n_cols]
                    n_cols += 1
                col_of[slot] = cols[0]
                fixed.setdefault((kind, aux), []).append((slot, cols))
        # The fixed parameters of each (kind, flavor) in one vectorised
        # pass.
        for (kind, aux), items in fixed.items():
            args = torch.tensor([[float(host[s]) for s in self._ops[slot][2]]
                                 for slot, _cols in items], dtype=_F64)
            transform, p0, p1 = self._standard_params(kind, aux,
                                                      list(args.unbind(1)))
            draw = UNIFORM if kind == "uniform-deviate" else NORMAL
            for (slot, cols), a, b in zip(items, p0.tolist(), p1.tolist()):
                rows += [(0, slot, draw, transform, 1, 0, c, a, b)
                         for c in cols]
        # The host values a device operation reads.
        needed = sorted({s for kind, slot, arg_slots, _aux in self._ops
                         if varying[slot] and slot not in col_of
                         for s in arg_slots if not varying[s]} |
                        {s for s in self._out_slots if not varying[s]})
        self._plan = {
            "mission_time": float(t_host), "rows": rows, "n_cols": n_cols,
            "col_of": col_of, "raw_of": raw_of, "hist_of": hist_of,
            "deviates": [op[1] for op in self._ops if op[0] in _DEVIATES],
            "needed": needed,
            "needed_values": torch.tensor([float(host[s]) for s in needed],
                                          dtype=_F64)}
        return self._plan

    def _run_sample(self, mission_time: torch.Tensor, key,
                    n_trials: int) -> torch.Tensor:
        """Slot ``s`` draws under ``fold_in(key, s)``, as the JAX tape's
        ``deviate_key`` gives it."""
        device = mission_time.device
        varying = self._varying()
        with span("sample.plan"):
            plan = self._sample_plan(to_host(mission_time.detach()))
            col_of, raw_of, hist_of = (plan["col_of"], plan["raw_of"],
                                       plan["hist_of"])
            slot_key = dict(zip(plan["deviates"],
                                fold_in_many(key, plan["deviates"])))
            row_keys = {(0, s): k for s, k in slot_key.items()}
            for s in hist_of:
                row_keys[1, s], row_keys[2, s] = split(slot_key[s])
            table = StandardTable()
            for source, slot, draw, transform, stride, offset, col, p0, \
                    p1 in plan["rows"]:
                table.add(row_keys[source, slot], draw, col, transform, p0,
                          p1, stride, offset)
        n_out = len(self._out_slots)
        n_cols = plan["n_cols"]
        block = torch.empty((n_trials, n_cols), dtype=_F64, device=device)
        draw_standard(table, block)
        values: list = [None] * self._n_slots
        if plan["needed"]:
            moved = to_device(plan["needed_values"], device)
            for s, v in zip(plan["needed"], moved.unbind()):
                values[s] = v

        # 3. The rest in tape order: gamma, beta and histogram deviates
        # (their parameters may be sampled) and every op they reach.
        for kind, slot, arg_slots, aux in self._ops:
            if not varying[slot]:
                continue
            a = [values[s] for s in arg_slots]
            if slot in col_of:
                values[slot] = block[:, col_of[slot]]
            elif slot in raw_of:
                x = block[:, raw_of[slot]]
                if kind == "uniform-deviate":
                    values[slot] = a[0] + (a[1] - a[0]) * x
                elif kind == "normal-deviate":
                    values[slot] = a[0] + a[1] * x
                else:
                    mu, sigma = self._lognormal_params(aux, a)
                    values[slot] = torch.exp(mu + sigma * x)
            elif kind == "gamma-deviate":
                k, theta = a
                values[slot] = draw_gamma([slot_key[slot]], k,
                                          n_trials)[0] * theta
            elif kind == "beta-deviate":
                alphas = torch.stack([torch.broadcast_to(x, (n_trials,))
                                      for x in a])
                logs = draw_gamma(split(slot_key[slot]), alphas,
                                  n_trials, log_space=True)
                values[slot] = beta_from_logs(logs[0], logs[1])
            elif kind == "histogram":
                g0, u_col = hist_of[slot]
                shape = (n_trials,)
                bounds = torch.stack([torch.broadcast_to(x, shape)
                                      for x in a[:aux + 1]], dim=-1)
                weights = torch.stack([torch.broadcast_to(x, shape)
                                       for x in a[aux + 1:]], dim=-1)
                logits = torch.log(torch.clamp(weights, min=1e-300))
                idx = torch.argmax(block[:, g0:g0 + aux] + logits, dim=-1)
                lo = torch.gather(bounds, -1, idx[:, None])[:, 0]
                hi = torch.gather(bounds, -1, idx[:, None] + 1)[:, 0]
                values[slot] = lo + (hi - lo) * block[:, u_col]
            else:
                values[slot] = self._evaluate(kind, aux, a, mission_time,
                                              None)

        # 4. The output columns the kernel did not write.
        for j, s in enumerate(self._out_slots):
            if self._root(s) not in col_of:
                block[:, j] = values[s]
        out = block[:, :n_out]
        return out if n_cols == n_out else out.contiguous()

    def evaluate_mean(self, mission_time, device) -> torch.Tensor:
        """Mean values on ``device``, shape ``mission_time.shape +
        (n_outputs,)``."""
        return self._run_mean(torch.as_tensor(mission_time, dtype=_F64,
                                              device=torch.device(device)))

    def sample(self, key, n_trials: int, mission_time,
               device) -> torch.Tensor:
        """Epistemic samples on ``device``, shape (n_trials, n_outputs),
        under the threefry key ``key`` (``ops/prng.py``: two 32-bit words,
        as ``jax.random`` keys are)."""
        return self._run_sample(to_device(mission_time, device, _F64), key,
                                n_trials)
