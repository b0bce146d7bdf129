"""An event tree's sequences quantified again from the model files and the
seed: the plain reference of the event-tree request kind.

It imports nothing of the program under test (nor JAX) and reads the
Open-PSA MEF itself, with the standard library: the fault trees and basic
events as ``mef.py`` reads them, and ``define-initiating-event`` (an
event-tree name, no expression), ``define-event-tree`` (functional
events, empty sequence definitions, the initial state), forks, paths,
``sequence`` and ``collect-formula``.  Anything else raises
``UnsupportedModel``: house events, CCF groups, parameters, rules, named
branches, links, house-event flips, if-then-else, private roles, and
``collect-expression`` (the MEF refuses a tree that mixes it with
``collect-formula``, and a tree of expressions alone has no formula to
evaluate).

**Method.**  Each gate's probability from its arguments' as though they
were independent, gate by gate in float64 (or the control's lower
precision): AND a product, OR ``1 - prod(1 - p)``, k-of-n the exact count
distribution of independent arguments, NOT ``1 - p``.  This is direct
propagation, the program's documented fallback when its BDD forest passes
its node limit; under basic events shared between a gate's arguments it
is not the exact probability of the formula, and it is what is judged,
since the configuration states that method.  A sequence's trials are the
product of the formulas collected along its path, in walk order.  Trials
go ``block`` at a time.

**Samples** are ``sampler.lognormal_block``'s, one column per basic event
the sequences reach, sorted by name: the expression tape's order, which
numbers each basic event's expression one slot per node after its
arguments' (a constant one slot, a lognormal deviate three for its
arguments, then its own), deviate slot ``s`` drawing under ``fold_in(key,
s)``, with ``key = fold_in(prng_key(seed), crc32(initiating event name) &
0x7FFFFFFF)``; clipped to [0, 1].

**Statistics** (:func:`sequence_stats`): the mean, the sample standard
deviation, the 95 % interval as NumPy's linear quantiles at 0.025 and
0.975, the error factor as the 95th percentile over the median (infinite
where the median is not above 0), and the number of trials.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch

from . import sampler
from .mef import (Lognormal, Model, UnsupportedModel, _children,
                  _expression, _formula)

__all__ = ["EventTreeReference", "Outcome", "read_event_tree_model",
           "sequence_stats"]


@dataclasses.dataclass
class Outcome:
    """One path of the walk: the sequence it reaches and the formulas
    collected along it."""
    sequence: str
    formulas: list


@dataclasses.dataclass
class EventTreeModel:
    fault_trees: Model
    #: initiating event name -> its walk's outcomes, in walk order.
    initiating: dict


def _refuse_private(node) -> None:
    if node.get("role", "public") != "public":
        raise UnsupportedModel(f"role {node.get('role')!r} on "
                               f"<{node.tag} name={node.get('name')!r}>")


def _walk(branch, formulas: list, out: list) -> None:
    """Run ``branch``'s instructions, then follow its target."""
    formulas = list(formulas)
    for node in branch:
        if node.tag == "sequence":
            out.append(Outcome(node.get("name"), formulas))
        elif node.tag == "fork":
            for path in node:
                if path.tag != "path":
                    raise UnsupportedModel(f"<{path.tag}> in a fork")
                _walk(path, formulas, out)
        elif node.tag == "collect-formula":
            (child,) = list(node)
            formulas.append(_formula(child))
        else:
            raise UnsupportedModel(f"instruction <{node.tag}>")


def read_event_tree_model(paths) -> EventTreeModel:
    model = Model({}, {}, [], {})
    trees, initiating = {}, {}

    def define_basic(node):
        _refuse_private(node)
        (expr,) = list(node)
        model.basic[node.get("name")] = _expression(expr)

    for path in paths:
        for node in ET.parse(path).getroot():
            if node.tag == "define-fault-tree":
                tree = node.get("name")
                model.fault_trees.append(tree)
                for child in node:
                    if child.tag == "define-gate":
                        _refuse_private(child)
                        (formula,) = list(child)
                        model.gates[child.get("name")] = _formula(formula)
                        model.gate_tree[child.get("name")] = tree
                    elif child.tag == "define-basic-event":
                        define_basic(child)
                    else:
                        raise UnsupportedModel(f"<{child.tag}> in a tree")
            elif node.tag == "model-data":
                for child in node:
                    if child.tag != "define-basic-event":
                        raise UnsupportedModel(f"<{child.tag}> in data")
                    define_basic(child)
            elif node.tag == "define-initiating-event":
                if len(node):
                    raise UnsupportedModel("an initiating event's "
                                           "expression")
                initiating[node.get("name")] = node.get("event-tree")
            elif node.tag == "define-event-tree":
                trees[node.get("name")] = node
            else:
                raise UnsupportedModel(f"<{node.tag}> at the top level")
    walked = {}
    for name, tree_name in initiating.items():
        tree = trees[tree_name]
        initial = None
        for child in tree:
            if child.tag == "initial-state":
                initial = child
            elif child.tag == "define-sequence":
                if len(child):
                    raise UnsupportedModel("instructions in a sequence")
            elif child.tag != "define-functional-event":
                raise UnsupportedModel(f"<{child.tag}> in an event tree")
        out: list = []
        _walk(initial, [], out)
        walked[name] = out
    return EventTreeModel(model, walked)


def _reached(model: Model, formulas) -> set:
    seen, basics = set(), set()
    stack = list(formulas)
    while stack:
        f = stack.pop()
        if f[0] == "gate":
            if f[1] not in seen:
                seen.add(f[1])
                stack.append(model.gates[f[1]])
        elif f[0] == "basic":
            basics.add(f[1])
        else:
            stack.extend(_children(f))
    return basics


def _at_least(k: int, ps: list):
    """P(at least ``k`` of independent events ``ps``): the count
    distribution below ``k``, the rest absorbed in ``k``."""
    dist = [torch.ones_like(ps[0])] + [torch.zeros_like(ps[0])] * k
    for p in ps:
        q = 1 - p
        new = [dist[0] * q]
        for j in range(1, k):
            new.append(dist[j] * q + dist[j - 1] * p)
        new.append(dist[k] + dist[k - 1] * p)
        dist = new
    return dist[k]


class _Block:
    """Formula values on one block of trials, each gate computed once."""

    def __init__(self, model: Model, p: torch.Tensor, column: dict):
        self.model, self.p, self.column = model, p, column
        self.gates: dict = {}

    def value(self, f):
        kind = f[0]
        if kind == "basic":
            return self.p[:, self.column[f[1]]]
        if kind == "gate":
            got = self.gates.get(f[1])
            if got is None:
                got = self.gates[f[1]] = self.value(self.model.gates[f[1]])
            return got
        if kind == "not":
            return 1 - self.value(f[1])
        args = [self.value(c) for c in _children(f)]
        if kind == "and":
            out = args[0]
            for a in args[1:]:
                out = out * a
            return out
        if kind == "or":
            out = 1 - args[0]
            for a in args[1:]:
                out = out * (1 - a)
            return 1 - out
        return _at_least(f[1], args)


def sequence_stats(x: np.ndarray) -> dict:
    x = np.asarray(x, dtype=np.float64)
    median = float(np.median(x))
    p95 = float(np.quantile(x, 0.95))
    lo, hi = np.quantile(x, [0.025, 0.975])
    return {"mean": float(x.mean()), "std": float(x.std(ddof=1)),
            "ci95": [float(lo), float(hi)],
            "error_factor": p95 / median if median > 0 else float("inf"),
            "n_trials": int(len(x))}


class EventTreeReference:
    """The sequences of the model's one initiating event."""

    def __init__(self, paths, device, block: int = 1 << 17):
        read = read_event_tree_model(paths)
        ((self.initiating, self.outcomes),) = read.initiating.items()
        self.model = read.fault_trees
        self.device = torch.device(device)
        self.block = block
        self.basics = sorted(_reached(
            self.model, [f for o in self.outcomes for f in o.formulas]))
        self.column = {n: i for i, n in enumerate(self.basics)}

    def sequences(self) -> list[str]:
        """Each outcome's sequence name, in walk order."""
        return [o.sequence for o in self.outcomes]

    def _key(self, seed: int):
        return sampler.fold_in(
            sampler.prng_key(seed),
            zlib.crc32(self.initiating.encode()) & 0x7FFFFFFF)

    def _evaluate(self, p: torch.Tensor, dtype) -> torch.Tensor:
        """(outcomes, trials) values in float64 from basic-event
        probabilities ``p`` (trials, basics), computed in ``dtype`` block
        by block."""
        out = torch.empty((len(self.outcomes), p.shape[0]),
                          dtype=torch.float64, device=self.device)
        for r0 in range(0, p.shape[0], self.block):
            r1 = min(r0 + self.block, p.shape[0])
            values = _Block(self.model, p[r0:r1].to(dtype), self.column)
            for i, outcome in enumerate(self.outcomes):
                value = torch.ones(r1 - r0, dtype=dtype, device=self.device)
                for k, f in enumerate(outcome.formulas):
                    value = values.value(f) if k == 0 else \
                        value * values.value(f)
                out[i, r0:r1] = value.to(torch.float64)
        return out

    def point_values(self) -> dict[str, float]:
        """Each sequence's value at the mean probabilities (lognormal
        means, clipped to [0, 1]), by sequence name."""
        means = [self.model.basic[n] for n in self.basics]
        p = torch.tensor([[min(max(e.mean if isinstance(e, Lognormal)
                                   else e, 0.0), 1.0) for e in means]],
                         dtype=torch.float64, device=self.device)
        values = self._evaluate(p, torch.float64)[:, 0]
        return dict(zip(self.sequences(), values.tolist()))

    def sequence_trials(self, seed: int, n_trials: int,
                        dtype=torch.float64) -> torch.Tensor:
        """(outcomes, n_trials) trials drawn under ``seed``."""
        p = sampler.lognormal_block([self.model.basic[n]
                                     for n in self.basics],
                                    self._key(seed), n_trials, self.device)
        out = self._evaluate(p, dtype)
        del p
        return out

    def sequence_uncertainty(self, seed: int, n_trials: int,
                             dtype=torch.float64) -> list[dict]:
        """Each outcome's statistics, in walk order, with its sequence's
        name under ``sequence``."""
        trials = self.sequence_trials(seed, n_trials, dtype).cpu().numpy()
        return [{"sequence": name, **sequence_stats(row)}
                for name, row in zip(self.sequences(), trials)]
