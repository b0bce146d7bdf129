"""Event trees compiled once and quantified per request.

:func:`compile_event_tree` does an initiating event's set-up once: the
walk into sequence outcomes; the sequences' path conditions compiled
together as one multi-root gate DAG, so shared subtrees appear once; each
root's house vector; and the attempt at one BDD forest per distinct house
vector (``build_bdd_multi``), which memoizes across the roots.  Each
root's point value over the basic events' mean probabilities comes from
its BDD, or, when a forest blows up, from one batched direct propagation
(row ``k`` on house vector ``k``), which takes gate inputs as independent
(``compiler/bdd.py`` calls it approximate).

:func:`sequence_uncertainty` is one request: every sequence's
distribution under parameter uncertainty over ``n_trials`` trials drawn
under ``seed``.  One expression tape covers the basic events, the
initiating event's expression and every collected expression, so a shared
parameter is sampled once per trial; its key is ``fold_in(prng_key(seed),
crc32(initiating name) & 0x7FFFFFFF)``, the JAX package's, so both
packages draw the same samples.  Sequence roots evaluate over the BDDs the
compile built (on CUDA each root through the stream kernel,
``make_bdd_evaluator``: one launch per root, f32, the method tag
``bdd-stream-f32``; on the CPU by the f64 level evaluation), or without
them by direct propagation in f64.  On CUDA that is one launch of the
multi-root stream kernel per distinct house row (usually one): the
compile schedules the roots sharing a house row as one program
(``ops/stream_kernel.compile_tree_stream`` with ``roots``), each shared
gate once, and puts its tables, staged columns and house vector on the
card, so a request uploads nothing of it.  On the CPU the gather engine
runs (one call when the house rows are uniform, else one per root), as
``propagate``'s auto dispatch keeps gather there.  A sequence's trials
are its root's times the
initiating event's and the collected expressions' samples.  The
sequences' statistics reduce where their trials live
(:func:`sequence_statistics`, through the uncertainty path's
:func:`~.uncertainty.order_statistics`): one sort of the (sequences,
trials) matrix, each row's order statistics and moments, and one copy of
ten numbers a sequence back to the host.  Each sequence's dict carries
``method`` (``"expression"`` for a sequence with no gate), so a demotion
is never silent.

``RiskAnalysis`` runs the same two calls, passing its phase timer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..compiler.bdd import BddBlowupError
from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import CompiledTree, compile_gates
from ..ops.prng import fold_in, prng_key
from ..ops.stream_kernel import (EncodedStream, compile_tree_stream,
                                 encode_stream, house_tensor,
                                 stream_roots_forward)
from ..settings import Algorithm, Settings
from ..utils.profiling import COUNTERS, span, to_device, to_host
from .bdd_eval import bdd_probability, make_bdd_evaluator
from .event_tree_walk import SequenceOutcome, walk_event_tree
from .propagate import propagate_probability
from .uncertainty import order_statistics

__all__ = ["CompiledEventTree", "RootGroup", "compile_event_tree",
           "root_groups", "sequence_uncertainty", "sequence_statistics"]


class _NoTimer:
    """A phase timer that times nothing."""

    @staticmethod
    def phase(_key: str):
        return contextlib.nullcontext()


@dataclasses.dataclass
class RootGroup:
    """The roots (indices into ``root_slots``) that share a house row, as
    one multi-root stream program, with its staged columns and house
    vector (float64) on the compiled tree's device."""

    roots: list[int]
    program: EncodedStream
    cols: torch.Tensor
    house: torch.Tensor


@dataclasses.dataclass
class CompiledEventTree:
    """An initiating event's walked and compiled sequences on ``device``.

    ``gates[i]`` is outcome ``i``'s path condition (None without collected
    formulas); the roots are the gates that are not None, in order.
    ``root_bdds`` holds each root's BDD, or None where the forest blew up
    (or the algorithm is not BDD) and direct propagation evaluates them;
    on CUDA ``root_groups`` then holds its programs.
    """

    initiating: Any
    outcomes: list[SequenceOutcome]
    gates: list
    device: torch.device
    mission: float
    tree: Optional[CompiledTree] = None
    root_slots: list[int] = dataclasses.field(default_factory=list)
    house_rows: list[np.ndarray] = dataclasses.field(default_factory=list)
    uniform_house: bool = False
    root_bdds: Optional[list] = None
    root_groups: list[RootGroup] = dataclasses.field(default_factory=list)
    #: Each root's point value over the mean probabilities.
    root_values: list[float] = dataclasses.field(default_factory=list)
    #: ``root_slots`` and ``house_rows`` on ``device``.
    root_index: Optional[torch.Tensor] = None
    house: Optional[torch.Tensor] = None
    _tape: Optional[ExpressionTape] = None
    _evaluators: Optional[list] = None

    def uncertainty_tape(self) -> ExpressionTape:
        """The tape over the basic events, then the initiating event's
        expression, then every collected expression in outcome order
        (built on the first request)."""
        if self._tape is None:
            init_expr = getattr(self.initiating, "expression", None)
            extras = ([init_expr] if init_expr is not None else []) + \
                [e for outcome in self.outcomes for e in outcome.expressions]
            self._tape = ExpressionTape.build(
                [e.expression for e in self.tree.basic_events] + extras)
        return self._tape

    def evaluators(self) -> list:
        """Each root's BDD evaluator (built on the first request)."""
        if self._evaluators is None:
            self._evaluators = [make_bdd_evaluator(bdd, self.device)
                                for bdd in self.root_bdds]
        return self._evaluators


def compile_event_tree(model, initiating, settings: Settings, device,
                       timer=None) -> CompiledEventTree:
    """Walk, compile and attempt the BDD forest of ``initiating``'s event
    tree once; ``timer`` (a ``PhaseTimer``) times the phases."""
    timer = timer or _NoTimer()
    device = torch.device(device)
    name = initiating.name
    with span("event_tree.compile"):
        with timer.phase(f"walk:{name}"):
            outcomes = walk_event_tree(model, initiating)
        gates = [outcome.conjoined_gate(f"__seq{i}__")
                 for i, outcome in enumerate(outcomes)]
        compiled = CompiledEventTree(initiating, outcomes, gates, device,
                                     settings.mission_time())
        roots = [g for g in gates if g is not None]
        if not roots:
            return compiled
        with timer.phase(f"compile:{name}"):
            tree = compile_gates(roots, use_ccf=settings.ccf_analysis())
            tape = ExpressionTape.build(
                [e.expression for e in tree.basic_events])
            mean_p = torch.clamp(tape.evaluate_mean(compiled.mission,
                                                    device), 0.0, 1.0)
            root_slots = [tree.gate_index[g.id] for g in roots]
            # House states may differ per outcome (path-local flips), so
            # each root carries its own house vector.
            house_rows = []
            for outcome, gate in zip(outcomes, gates):
                if gate is None:
                    continue
                house = tree.house_state_vector()
                for event_id, state in outcome.house_states.items():
                    slot = tree.house_index.get(event_id)
                    if slot is not None:
                        house[slot - tree.n_basic] = 1.0 if state else 0.0
                house_rows.append(house)
            compiled.tree = tree
            compiled.root_slots = root_slots
            compiled.house_rows = house_rows
            compiled.uniform_house = all((h == house_rows[0]).all()
                                         for h in house_rows)
            compiled.root_index = to_device(
                np.asarray(root_slots, dtype=np.int64), device)
            compiled.house = to_device(np.stack(house_rows), device)
        values = None
        if settings.algorithm() == Algorithm.BDD:
            values = _forest(compiled, mean_p, timer)
        if values is None:
            # One batched propagation: row k uses house vector k (the means
            # broadcast to every row, also without house events).
            with timer.phase(f"propagation:{name}"):
                all_vals = propagate_probability(
                    tree, mean_p.expand(len(house_rows), -1),
                    compiled.house)
                rows = torch.arange(len(root_slots), device=device)
                values = to_host(all_vals[rows, compiled.root_index]
                                 ).tolist()
                del all_vals
                if device.type == "cuda":
                    compiled.root_groups = root_groups(compiled)
        compiled.root_values = values
    return compiled


def _by_house(house_rows: list[np.ndarray]) -> list[list[int]]:
    """The roots grouped by identical house row, in order of first
    appearance."""
    groups: dict[bytes, list[int]] = {}
    for k, h in enumerate(house_rows):
        groups.setdefault(h.tobytes(), []).append(k)
    return list(groups.values())


def root_groups(compiled: CompiledEventTree) -> list[RootGroup]:
    """One multi-root stream program per distinct house row, its tables,
    output slots, staged columns and house vector put on the compiled
    tree's device once (``compile_event_tree`` builds them on CUDA, where
    the forest gives up)."""
    device = compiled.device
    groups = []
    for ks in _by_house(compiled.house_rows):
        program = encode_stream(compile_tree_stream(
            compiled.tree, [compiled.root_slots[k] for k in ks]))
        program.tables(device)      # with its output slots
        groups.append(RootGroup(
            ks, program, to_device(program.staged_cols, device),
            house_tensor(program, compiled.house_rows[ks[0]], device,
                         torch.float64)))
    return groups


def _forest(compiled: CompiledEventTree, mean_p: torch.Tensor, timer
            ) -> list[float] | None:
    """One forest per distinct house configuration (usually one), its ITE
    memo tables shared by every root: each root's BDD into
    ``compiled.root_bdds`` and its point value returned; None where a
    forest blows up."""
    from ..compiler.bdd import build_bdd_multi
    tree, house_rows = compiled.tree, compiled.house_rows
    with timer.phase(f"bdd-forest:{compiled.initiating.name}"), \
            span("event_tree.forest"):
        root_bdds = [None] * len(house_rows)
        values = [0.0] * len(house_rows)
        try:
            for ks in _by_house(house_rows):
                bdds = build_bdd_multi(
                    tree, [compiled.root_slots[k] for k in ks],
                    house_states=house_rows[ks[0]])
                for k, bdd in zip(ks, bdds):
                    root_bdds[k] = bdd
                    values[k] = float(bdd_probability(bdd, mean_p))
        except BddBlowupError:
            COUNTERS["forest_blowups"] += 1
            return None
    compiled.root_bdds = root_bdds
    return values


def sequence_uncertainty(compiled: CompiledEventTree, seed: int,
                         n_trials: int, timer=None
                         ) -> dict[int, dict] | None:
    """Each sequence's uncertainty over ``n_trials`` trials drawn under
    ``seed``, by outcome index; None without roots or without deviates."""
    if compiled.tree is None:
        return None
    tape = compiled.uncertainty_tape()
    if not tape.n_deviates:
        return None
    timer = timer or _NoTimer()
    name = compiled.initiating.name
    tree = compiled.tree
    with span("event_tree"):
        with timer.phase(f"sampling:{name}"), span("event_tree.sample"):
            key = fold_in(prng_key(seed),  # crc32: stable across processes
                          zlib.crc32(name.encode()) & 0x7FFFFFFF)
            samples = tape.sample(key, n_trials, compiled.mission,
                                  compiled.device)
            basic_s = torch.clamp(samples[:, :tree.n_basic], 0.0, 1.0)
        with timer.phase(f"sequence-evaluation:{name}"):
            with span("event_tree.evaluate"), torch.no_grad():
                tops, method = _evaluate_roots(compiled, basic_s, n_trials)
                trials = _sequence_trials(compiled, samples, tops,
                                          n_trials)
            with span("event_tree.statistics"):
                stats = sequence_statistics(
                    torch.stack(list(trials.values())))
                out: dict[int, dict] = {}
                for k, row in zip(trials, stats):
                    row["method"] = method \
                        if compiled.gates[k] is not None else "expression"
                    out[k] = row
                    COUNTERS["sequences"] += 1
    return out


def _evaluate_roots(compiled: CompiledEventTree, basic_s: torch.Tensor,
                    n_trials: int) -> tuple[list[torch.Tensor], str]:
    """Each root's trials, and the method that computed them."""
    tree = compiled.tree
    if compiled.root_bdds is not None:
        method = "bdd"
        tops = []
        for evaluator in compiled.evaluators():
            tops.append(evaluator(basic_s))
            if evaluator.method != "bdd":
                method = evaluator.method
        return tops, method
    if compiled.device.type == "cuda":
        # One launch per house row; the samples staged in float64.
        tops = [None] * len(compiled.root_slots)
        for group in compiled.root_groups:
            staged = basic_s.to(torch.float64)[:, group.cols].T.contiguous()
            out = stream_roots_forward(group.program, staged, group.house)
            for k, row in zip(group.roots, out):
                tops[k] = row
        return tops, "direct-propagation"
    if compiled.uniform_house:
        vals = propagate_probability(tree, basic_s, compiled.house[0])
        tops = vals[:, compiled.root_index]
        del vals
        return [tops[:, k] for k in range(len(compiled.root_slots))], \
            "direct-propagation"
    tops = []
    for k, slot in enumerate(compiled.root_slots):
        vals = propagate_probability(tree, basic_s, compiled.house[k])
        tops.append(vals[:, slot].clone())
        del vals
    return tops, "direct-propagation"


def _sequence_trials(compiled: CompiledEventTree, samples: torch.Tensor,
                     tops: list[torch.Tensor], n_trials: int
                     ) -> dict[int, torch.Tensor]:
    """Each outcome's trials: the initiating event's sample, times each
    collected expression's, times its root's (where it has a gate)."""
    col = compiled.tree.n_basic
    init_s = None
    if getattr(compiled.initiating, "expression", None) is not None:
        init_s = samples[:, col]
        col += 1
    out: dict[int, torch.Tensor] = {}
    cursor = 0
    for k, (outcome, gate) in enumerate(zip(compiled.outcomes,
                                            compiled.gates)):
        trial = torch.ones((n_trials,), dtype=torch.float64,
                           device=compiled.device)
        if init_s is not None:
            trial = trial * init_s
        for _expr in outcome.expressions:
            trial = trial * samples[:, col]
            col += 1
        if gate is not None:
            trial = trial * tops[cursor]
            cursor += 1
        out[k] = trial
    return out


def sequence_statistics(rows: torch.Tensor) -> list[dict]:
    """Each row's mean, sample standard deviation (0.0 for one trial),
    95 % interval (NumPy's linear quantiles at 0.025 and 0.975), error
    factor (the 95th percentile over the median, ``inf`` where the median
    is not positive) and number of trials, from an (S, n) float64 matrix
    reduced on its own device by :func:`~.uncertainty.order_statistics`:
    one sort along the trials, one copy back, the interval, the median
    and the 95th percentile equal to NumPy's on each row to the bit."""
    n = rows.shape[1]
    stats = order_statistics(rows, np.array([0.025, 0.975]))
    std = stats.std if n > 1 else np.zeros_like(stats.std)
    return [{"mean": float(m), "std": float(sd),
             "ci95": [float(lo), float(hi)], "error_factor": float(ef),
             "n_trials": int(n)}
            for m, sd, (lo, hi), ef in zip(stats.mean, std, stats.quantiles,
                                           stats.error_factor)]
