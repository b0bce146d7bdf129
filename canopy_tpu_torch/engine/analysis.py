"""Risk analysis: Settings x Model -> Report, on a torch device.

``canopy_tpu/engine/analysis.py`` ported.  Per fault-tree top event:

* **probability** — exact over the modular BDD (f64 level evaluation),
  direct propagation (the f64 gather engine) when the BDD blows up or the
  algorithm is not BDD, or rare-event/MCUB over minimal products;
* **products** — minimal cut sets through the ZBDD (or MOCUS), with
  non-declarative substitutions applied;
* **importance** — autodiff-based measures (one backward pass; on CUDA
  through the adjoint kernel, over the BDD's stream program or, without
  one, the tree's);
* **uncertainty** — batched epistemic sampling through the expression
  tape (on CUDA through the stream kernel over the BDD, or without one
  through ``make_propagator``'s stream kernel);
* **Monte Carlo approximation** — the bit-packed engine
  (``ops/bitpack.packed_top_probability``), its states drawn by the
  Philox kernel on CUDA (``ops/bernoulli_kernel.py``), with the normal
  standard error of the estimate;
* **SIL and time curves** — one batched tape evaluation over the time
  points, one batched quantification, PFD/PFH averages and the IEC 61508
  bands;
* **alignment phases** — per phase, the phase's house states at the
  phase's share of the mission time: all phases in one batched pass
  (grouped by house vector) under the default exact configuration, else
  one re-analysis per phase;

and per initiating event, the event-tree walk with every sequence
quantified over one multi-root compiled tree (one BDD forest per distinct
house vector, or one batched direct propagation when the forest blows
up), with per-sequence uncertainty (on CUDA the stream kernel, one launch
per sequence root): ``engine/sequences.py``'s compile and request, the
path an event tree is served on.

The device is named by the caller.  Where the JAX package asks whether
its backend is a TPU, this module asks whether the device is CUDA.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..compiler.bdd import BddBlowupError, build_bdd
from ..compiler.cutsets import CutSetGenerator, Product
from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import CompiledTree, compile_fault_tree
from ..errors import LogicError
from ..mef.event import BasicEvent, Gate
from ..mef.model import Model
from ..settings import Algorithm, Approximation, Settings
from ..utils.profiling import PhaseTimer
from .bdd_eval import make_modular_evaluator
from .cutset_quantify import (build_cutset_matrix, mcub,
                              product_probabilities, rare_event)
from .importance import (importance_measures, make_stream_importance_fn,
                         occurrence_counts)
from .propagate import top_event_probability
from .sequences import compile_event_tree, sequence_uncertainty
from .uncertainty import uncertainty_analysis

__all__ = ["RiskAnalysis", "Report", "FaultTreeResult", "SequenceResult"]

#: IEC 61508 SIL bands for average probability of failure on demand.
_SIL_PFD_BANDS = [(1e-5, 1e-4, 4), (1e-4, 1e-3, 3), (1e-3, 1e-2, 2),
                  (1e-2, 1e-1, 1)]


@dataclasses.dataclass
class FaultTreeResult:
    fault_tree: str
    top_event: str
    method: str
    probability: Optional[float] = None
    mc_std_error: Optional[float] = None
    products: Optional[list[tuple]] = None      # [(order, prob, [literals])]
    n_products: Optional[int] = None
    products_truncated: bool = False
    importance: Optional[list[dict]] = None
    uncertainty: Optional[dict] = None
    sil: Optional[dict] = None
    phase: Optional[str] = None
    alignment: Optional[str] = None
    time_curve: Optional[list[tuple[float, float]]] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass
class SequenceResult:
    initiating_event: str
    event_tree: str
    sequence: str
    states: dict[str, str]
    probability: float
    linked_trees: list[str]
    uncertainty: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    model: str
    settings: dict
    fault_trees: list[FaultTreeResult]
    sequences: list[SequenceResult]
    timings: dict[str, float]

    def to_dict(self) -> dict:
        return {"model": self.model, "settings": self.settings,
                "fault_trees": [r.to_dict() for r in self.fault_trees],
                "sequences": [s.to_dict() for s in self.sequences],
                "timings": self.timings}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), default=_json_default, **kw)


def _json_default(obj: Any):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Cannot serialize {type(obj)}")


class RiskAnalysis:
    """Runs every analysis requested by the settings on a model, on
    ``device`` (``"cpu"`` or ``"cuda"``; never chosen implicitly)."""

    def __init__(self, model: Model, settings: Settings, device):
        self.model = model
        self.settings = settings
        self.device = resolve_device(device)
        self._timer = PhaseTimer(self.device)

    # -- public ------------------------------------------------------------

    def run(self) -> Report:
        results: list[FaultTreeResult] = []
        sequences: list[SequenceResult] = []
        preprocessor = self.settings.preprocessor
        with self._timer.phase("total"):
            for fault_tree in self.model.fault_trees:
                if not fault_tree.top_events:
                    fault_tree.collect_top_events()
                for top in fault_tree.top_events:
                    if preprocessor:
                        # Stop after model setup (settings.h:310): report
                        # structure only, no quantification.
                        results.append(FaultTreeResult(
                            fault_tree=fault_tree.name, top_event=top.id,
                            method="preprocessor-only"))
                    else:
                        results.extend(self._analyze_top(fault_tree.name,
                                                         top))
            for initiating in self.model.initiating_events:
                if initiating.event_tree is not None and not preprocessor:
                    sequences.extend(self._analyze_event_tree(initiating))
        return Report(model=self.model.name,
                      settings=self.settings.to_dict(),
                      fault_trees=results, sequences=sequences,
                      timings=dict(self._timer.times))

    # -- fault trees -------------------------------------------------------

    def _analyze_top(self, tree_name: str, top: Gate,
                     house_overrides: dict[str, bool] | None = None,
                     mission_time: float | None = None,
                     tag: tuple[str, str] | None = None
                     ) -> list[FaultTreeResult]:
        """The results of ``top``: its own, then (at the root call of a
        model with alignments) one per alignment phase."""
        settings = self.settings
        device = self.device
        on_cuda = device.type == "cuda"
        with self._timer.phase(f"compile:{top.id}"):
            tree = compile_fault_tree(
                _FaultTreeView(tree_name, [top]), top,
                use_ccf=settings.ccf_analysis())

        mission = (settings.mission_time() if mission_time is None
                   else mission_time)
        self.model.mission_time.set_value(mission)
        tape = ExpressionTape.build(
            [e.expression for e in tree.basic_events])
        mean_p = torch.clamp(tape.evaluate_mean(mission, device), 0.0, 1.0)
        house = tree.house_state_vector()
        for event_id, state in (house_overrides or {}).items():
            slot = tree.house_index.get(event_id)
            if slot is not None:
                house[slot - tree.n_basic] = 1.0 if state else 0.0
        house_t = torch.as_tensor(house, device=device)

        # Exact (BDD) evaluator: the default algorithm.  House states fold
        # into the BDD structure, so it is built after overrides apply.
        # Modular decomposition (Dutuit-Rauzy) keeps per-module BDDs
        # small; a tree with no modules degenerates to one monolithic BDD.
        top_fn = None
        modular_bdd = None
        method = self._method_name()
        if settings.algorithm() == Algorithm.BDD and \
                settings.approximation() == Approximation.NONE:
            try:
                with self._timer.phase(f"bdd:{top.id}"):
                    from ..compiler.modules import (build_modular_bdd,
                                                    modular_probability)
                    modular = build_modular_bdd(tree, house_states=house)
                modular_bdd = modular
                top_fn = lambda p: modular_probability(modular, p)  # noqa: E731
            except BddBlowupError:
                method = "bdd-fallback/direct-propagation"

        result = FaultTreeResult(
            fault_tree=tree_name, top_event=top.id, method=method)
        if tag:
            result.alignment, result.phase = tag
        mean_np = mean_p.cpu().numpy()

        # Products (qualitative analysis).
        products: list[Product] | None = None
        if not settings.skip_products() and settings.algorithm() in (
                Algorithm.MOCUS, Algorithm.ZBDD, Algorithm.BDD,
                Algorithm.DIRECT):
            with self._timer.phase(f"products:{top.id}"):
                generator = CutSetGenerator(
                    tree, limit_order=settings.limit_order(),
                    cut_off=settings.cut_off()
                    if settings.approximation() != Approximation.NONE else 0.0,
                    probabilities=mean_np)
                products = None
                bdd_truncated = None
                if top_fn is not None and not settings.prime_implicants():
                    # Exact minimal cut sets via the ZBDD minimal-solutions
                    # transform over a monolithic BDD (module pseudo-events
                    # would leak into products otherwise).
                    try:
                        from ..compiler.zbdd import bdd_minimal_cut_sets
                        bdd = build_bdd(tree, house_states=house)
                        products, bdd_truncated = bdd_minimal_cut_sets(
                            bdd, limit_order=settings.limit_order(),
                            with_truncation=True)
                    except BddBlowupError:
                        products = None
                elif top_fn is not None:
                    # True prime implicants via the Coudert-Madre consensus
                    # recursion on the ROBDD (settings.h:77-90).
                    try:
                        from ..compiler.prime_implicants import \
                            bdd_prime_implicants
                        bdd = build_bdd(tree, house_states=house)
                        products, bdd_truncated = bdd_prime_implicants(
                            bdd, limit_order=settings.limit_order(),
                            with_truncation=True)
                    except (BddBlowupError, LogicError):
                        # Record the demotion (never demote silently).
                        products = None
                        result.method += "/pi-fallback-mocus-approx"
                if products is None:
                    products = generator.generate(top)
                if not settings.prime_implicants():
                    # Minimal-cut-set mode: complemented literals are dropped
                    # (conservative coherent approximation — SCRAM's MOCUS
                    # behavior).
                    products = CutSetGenerator._minimize(
                        frozenset(lit for lit in p if not lit[1])
                        for p in products)
                products = self._apply_substitutions(tree, products)
                result.products_truncated = (bdd_truncated
                                             if bdd_truncated is not None
                                             else generator.truncated)
                result.n_products = len(products)

        if settings.probability_analysis():
            with self._timer.phase(f"probability:{top.id}"):
                approx = settings.approximation()
                if approx == Approximation.NONE:
                    if top_fn is not None:
                        result.probability = float(top_fn(mean_p))
                    else:
                        result.probability = float(
                            top_event_probability(tree, mean_p, house_t))
                elif approx in (Approximation.RARE_EVENT, Approximation.MCUB):
                    matrix = build_cutset_matrix(products or [], tree.n_basic)
                    q = product_probabilities(matrix, mean_p)
                    value = rare_event(q) \
                        if approx == Approximation.RARE_EVENT else mcub(q)
                    result.probability = float(value)
                else:  # Monte Carlo state simulation (bit-packed engine).
                    from ..ops.bitpack import packed_top_probability
                    from .sampler import monte_carlo_ci

                    n = settings.num_trials() * settings.sample_size()
                    n = -(-n // 32) * 32  # Round up to whole 32-trial words.
                    # On CUDA the Philox kernel samples (csrc/bernoulli.cu) and
                    # raises if it cannot build or launch: no fallback.
                    estimate = packed_top_probability(
                        tree, settings.seed(), mean_p, n, house, device)
                    result.probability = float(estimate)
                    result.mc_std_error = float(monte_carlo_ci(estimate, n))

        if products is not None:
            probs = product_probabilities(
                build_cutset_matrix(products, tree.n_basic),
                mean_p).cpu().numpy() if products else np.zeros(0)
            listed = sorted(zip(products, probs),
                            key=lambda pair: -pair[1])
            result.products = [
                (len(p), float(q), sorted(
                    self._literal_name(tree, slot, neg) for slot, neg in p))
                for p, q in listed[:1000]]

        if settings.importance_analysis():
            with self._timer.phase(f"importance:{top.id}"):
                # On CUDA the backward pass runs as the adjoint stream kernel
                # (ops/adjoint_kernel.py), on one trial (the kernels take any
                # trial count) and in f64: in f32 the Shannon partials
                # (hi - lo) * a cancel, and small MIFs lose three digits.
                # Without a BDD it differentiates the tree's stream program.
                imp_fn = top_fn
                if on_cuda and modular_bdd is not None:
                    ev = make_modular_evaluator(modular_bdd, device,
                                                differentiable=True,
                                                dtype=torch.float64)
                    imp_fn = lambda p: ev(p[None, :])[0]  # noqa: E731
                elif on_cuda:
                    imp_fn = make_stream_importance_fn(tree, house, device)
                imp = importance_measures(tree, mean_p, house_t, top_fn=imp_fn)
                if products is not None:
                    imp.occurrences = occurrence_counts(products, tree.n_basic)
                result.importance = imp.as_table(tree)

        if settings.uncertainty_analysis() and tape.n_deviates:
            with self._timer.phase(f"uncertainty:{top.id}"):
                # Uncertainty propagates through the same quantification the
                # point estimate used: exact BDD when available, otherwise the
                # configured cut-set approximation per trial, otherwise direct
                # propagation (make_propagator: the stream kernel on CUDA).
                unc_fn = top_fn
                unc_method = None
                if modular_bdd is not None and on_cuda:
                    # Exact per-trial evaluation through the stream kernel, in
                    # f32: the method tag carries the precision so the
                    # demotion from the f64 level evaluation is never silent.
                    unc_fn = make_modular_evaluator(modular_bdd, device)
                    unc_method = unc_fn.method
                if unc_fn is None and products is not None and \
                        settings.approximation() in (Approximation.RARE_EVENT,
                                                     Approximation.MCUB):
                    matrix_u = build_cutset_matrix(products, tree.n_basic)
                    reducer = (rare_event
                               if settings.approximation() ==
                               Approximation.RARE_EVENT else mcub)
                    unc_fn = lambda p: reducer(  # noqa: E731
                        product_probabilities(matrix_u, p))
                unc = uncertainty_analysis(
                    tree, tape, settings.seed(), settings.num_trials(),
                    mission, device, num_quantiles=settings.num_quantiles(),
                    num_bins=settings.num_bins(), house_states=house,
                    batch_size=(settings.batch_size()
                                if settings.batch_size() > 1 else None),
                    top_fn=unc_fn)
                ci = unc.confidence_interval(0.95)
                result.uncertainty = {
                    "mean": unc.mean, "std": unc.std,
                    "error_factor": unc.error_factor,
                    "ci95": list(ci), "n_trials": unc.n_trials,
                    "quantiles": unc.quantiles.tolist(),
                    "histogram_edges": unc.histogram_edges.tolist(),
                    "histogram_density": unc.histogram_density.tolist()}
                if unc_method is not None:
                    result.uncertainty["method"] = unc_method

        if settings.safety_integrity_levels():
            result.sil, result.time_curve = self._sil_analysis(
                tree, tape, house_t, mission, top_fn=top_fn)
        elif settings.time_step() > 0 and settings.probability_analysis():
            # Time-stepped probability curve without the SIL metrics.
            _, result.time_curve = self._sil_analysis(
                tree, tape, house_t, mission, top_fn=top_fn)

        out = [result]

        # Alignment phases (only at the root call): one compile and one
        # batched evaluation for all phases in the default BDD-exact
        # configuration; analyses that give per-phase artifacts
        # (importance, uncertainty, SIL, time curves, approximations,
        # prime implicants) re-analyse each phase.
        if house_overrides is None and tag is None and \
                self.model.alignments:
            batched_ok = (
                settings.algorithm() == Algorithm.BDD
                and settings.approximation() == Approximation.NONE
                and not settings.prime_implicants()
                and not settings.importance_analysis()
                and not settings.uncertainty_analysis()
                and not settings.safety_integrity_levels()
                and settings.time_step() <= 0)
            if batched_ok:
                out.extend(self._analyze_phases_batched(
                    tree_name, top, tree, tape, mission))
            else:
                for alignment in self.model.alignments:
                    for phase in alignment.phases:
                        overrides = {inst.name: inst.state
                                     for inst in phase.instructions}
                        out.extend(self._analyze_top(
                            tree_name, top, house_overrides=overrides,
                            mission_time=mission * phase.time_fraction,
                            tag=(alignment.name, phase.name)))
        return out

    def _analyze_phases_batched(self, tree_name: str, top: Gate,
                                tree: CompiledTree, tape: ExpressionTape,
                                mission: float) -> list[FaultTreeResult]:
        """All alignment phases of ``top`` in one batched pass.

        Reuses the root analysis' compiled tree and expression tape; the
        phases' mean probabilities come from one batched tape evaluation
        over the phase mission times.  Phases group by house vector: each
        group shares one modular BDD and one products run
        (mission-independent at approximation NONE) and quantifies all
        its phases in one batched evaluation.
        """
        settings = self.settings
        device = self.device
        with self._timer.phase(f"phases:{top.id}"):
            house_rows, times, tags = [], [], []
            for alignment in self.model.alignments:
                for phase in alignment.phases:
                    house = tree.house_state_vector()
                    for inst in phase.instructions:
                        slot = tree.house_index.get(inst.name)
                        if slot is not None:
                            house[slot - tree.n_basic] = \
                                1.0 if inst.state else 0.0
                    house_rows.append(house)
                    times.append(mission * phase.time_fraction)
                    tags.append((alignment.name, phase.name))
            p_batch = torch.clamp(
                tape.evaluate_mean(np.asarray(times), device), 0.0, 1.0)
            results: list[FaultTreeResult | None] = [None] * len(tags)
            by_house: dict[bytes, list[int]] = {}
            for i, h in enumerate(house_rows):
                by_house.setdefault(h.tobytes(), []).append(i)
            for ks in by_house.values():
                house = house_rows[ks[0]]
                method = self._method_name()
                top_fn = None
                try:
                    from ..compiler.modules import (build_modular_bdd,
                                                    modular_probability)
                    modular = build_modular_bdd(tree, house_states=house)
                    top_fn = lambda p, m=modular: (  # noqa: E731
                        modular_probability(m, p))
                except BddBlowupError:
                    method = "bdd-fallback/direct-propagation"
                products = None
                truncated = None
                if not settings.skip_products():
                    generator = CutSetGenerator(
                        tree, limit_order=settings.limit_order(), cut_off=0.0,
                        probabilities=p_batch[ks[0]].cpu().numpy())
                    if top_fn is not None:
                        try:
                            from ..compiler.zbdd import bdd_minimal_cut_sets
                            bdd = build_bdd(tree, house_states=house)
                            products, truncated = bdd_minimal_cut_sets(
                                bdd, limit_order=settings.limit_order(),
                                with_truncation=True)
                        except BddBlowupError:
                            products = None
                    if products is None:
                        products = generator.generate(top)
                        truncated = generator.truncated
                    products = CutSetGenerator._minimize(
                        frozenset(lit for lit in p if not lit[1])
                        for p in products)
                    products = self._apply_substitutions(tree, products)
                # One batched quantification across this group's phases.
                group_p = p_batch[torch.as_tensor(ks, device=device)]
                probs = None
                if settings.probability_analysis():
                    if top_fn is not None:
                        probs = top_fn(group_p).cpu().numpy()
                    else:
                        probs = top_event_probability(
                            tree, group_p,
                            torch.as_tensor(house, device=device)
                        ).cpu().numpy()
                prod_probs = None
                if products:
                    prod_probs = product_probabilities(
                        build_cutset_matrix(products, tree.n_basic),
                        group_p).cpu().numpy()
                for j, k in enumerate(ks):
                    result = FaultTreeResult(
                        fault_tree=tree_name, top_event=top.id, method=method)
                    result.alignment, result.phase = tags[k]
                    if probs is not None:
                        result.probability = float(probs[j])
                    if products is not None:
                        result.n_products = len(products)
                        result.products_truncated = truncated
                        qs = prod_probs[j] if prod_probs is not None \
                            else np.zeros(0)
                        listed = sorted(zip(products, qs),
                                        key=lambda pair: -pair[1])
                        result.products = [
                            (len(p), float(q), sorted(
                                self._literal_name(tree, slot, neg)
                                for slot, neg in p))
                            for p, q in listed[:1000]]
                    results[k] = result
        return [r for r in results if r is not None]

    def _method_name(self) -> str:
        algo = self.settings.algorithm().name.lower()
        approx = self.settings.approximation().name.lower()
        return f"{algo}/{approx}" if approx != "none" else \
            f"{algo}/direct-propagation"

    def _literal_name(self, tree: CompiledTree, slot: int, neg: bool) -> str:
        # Precomputed slot -> name array, cached ON the tree instance
        # (an id()-keyed dict would alias a freed tree's address to a
        # new one and return wrong names): the dict scan was O(n_basic)
        # per literal — quadratic over large product lists.
        names = getattr(tree, "_slot_name_cache", None)
        if names is None:
            names = [None] * tree.n_basic
            for event_id, s in tree.basic_index.items():
                names[s] = event_id
            tree._slot_name_cache = names
        event_id = names[slot] if slot < len(names) else None
        if event_id is None:
            return f"slot{slot}"
        return f"not {event_id}" if neg else event_id

    # -- SIL ---------------------------------------------------------------

    def _sil_analysis(self, tree: CompiledTree, tape: ExpressionTape,
                      house: torch.Tensor, mission: float, top_fn=None):
        """(SIL metrics, time curve): the tape evaluated once over every
        time point, the whole sweep quantified in one batched call."""
        step = self.settings.time_step()
        times = np.arange(step, mission + step / 2, step)
        if len(times) == 0:
            times = np.array([mission])
        p_t = torch.clamp(tape.evaluate_mean(times, self.device), 0.0, 1.0)
        if top_fn is not None:
            curve_t = top_fn(p_t)
        else:
            curve_t = top_event_probability(tree, p_t, house)
        curve_arr = curve_t.detach().cpu().numpy().astype(np.float64)
        pfd_avg = float(curve_arr.mean())
        # Average failure frequency (PFH): mean d/dt of the curve.
        pfh_avg = float(np.gradient(curve_arr, times).mean()) \
            if len(times) > 1 else pfd_avg / float(times[0])
        sil_level = 0
        for lo, hi, level in _SIL_PFD_BANDS:
            if lo <= pfd_avg < hi:
                sil_level = level
                break
        # Fraction of time in each band (SCRAM-style SIL fractions).
        fractions = {}
        for lo, hi, level in _SIL_PFD_BANDS:
            fractions[f"SIL{level}"] = float(
                np.mean((curve_arr >= lo) & (curve_arr < hi)))
        sil = {"pfd_avg": pfd_avg, "pfh_avg": pfh_avg,
               "sil_level": sil_level, "pfd_fractions": fractions}
        time_curve = list(zip(times.tolist(), curve_arr.tolist()))
        return sil, time_curve

    # -- substitutions -----------------------------------------------------

    def _apply_substitutions(self, tree: CompiledTree,
                             products: list[Product]) -> list[Product]:
        """Apply substitution semantics at the product level."""
        substitutions = list(self.model.substitutions)
        if not substitutions:
            return products

        def slot_of(event: BasicEvent) -> int | None:
            return tree.basic_index.get(event.id)

        out = products
        for substitution in substitutions:
            hypothesis_slots = []
            skip = False
            for arg in substitution.hypothesis.args:
                slot = slot_of(arg.event)
                if slot is None:
                    skip = True
                    break
                hypothesis_slots.append((slot, arg.complement))
            if skip:
                continue
            hyp = set(hypothesis_slots)
            source_slots = {slot_of(e) for e in substitution.source}
            source_slots.discard(None)
            target = substitution.target

            new_products: list[Product] = []
            for product in out:
                literals = set(product)
                if not hyp <= literals:
                    new_products.append(product)
                    continue
                # Hypothesis satisfied by this product.
                if target is False:
                    continue  # delete-terms: drop the product.
                if target is True or not source_slots:
                    new_products.append(product)
                    continue
                replaced = {lit for lit in literals
                            if lit[0] not in source_slots}
                if isinstance(target, BasicEvent):
                    t_slot = slot_of(target)
                    if t_slot is not None:
                        replaced.add((t_slot, False))
                new_products.append(frozenset(replaced))
            out = new_products
        # Re-minimize after rewriting.
        return CutSetGenerator._minimize(out)

    # -- event trees -------------------------------------------------------

    def _analyze_event_tree(self, initiating) -> list[SequenceResult]:
        """All sequences quantified over one shared compiled structure
        (``engine/sequences.compile_event_tree``), with each sequence's
        uncertainty where the settings ask for it (one
        ``sequence_uncertainty`` request under the settings' seed).  A
        sequence's probability is its root's point value times the
        initiating event's and the collected expressions' values.
        """
        settings = self.settings
        name = initiating.name
        with self._timer.phase(f"event-tree:{name}"):
            compiled = compile_event_tree(self.model, initiating, settings,
                                          self.device, self._timer)
            seq_unc = None
            if compiled.tree is not None and \
                    settings.uncertainty_analysis():
                seq_unc = sequence_uncertainty(
                    compiled, settings.seed(), settings.num_trials(),
                    self._timer)

            results = []
            cursor = 0
            for k, (outcome, gate) in enumerate(zip(compiled.outcomes,
                                                    compiled.gates)):
                probability = 1.0
                if getattr(initiating, "expression", None) is not None:
                    probability *= initiating.expression.value()
                for expression in outcome.expressions:
                    probability *= expression.value()
                if gate is not None:
                    probability *= compiled.root_values[cursor]
                    cursor += 1
                results.append(SequenceResult(
                    initiating_event=name,
                    event_tree=initiating.event_tree.name,
                    sequence=outcome.sequence.name,
                    states=outcome.states,
                    probability=probability,
                    linked_trees=outcome.linked_trees,
                    uncertainty=seq_unc.get(k) if seq_unc else None))
        return results


class _FaultTreeView:
    """Minimal adapter so compile_fault_tree can anchor at a chosen top."""

    def __init__(self, name: str, top_events: list[Gate]):
        self.name = name
        self.top_events = top_events

    def collect_top_events(self):  # pragma: no cover - already collected
        pass
