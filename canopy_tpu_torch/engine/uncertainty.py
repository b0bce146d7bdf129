"""Epistemic uncertainty analysis: batched sampling + distribution stats.

The reference's Monte-Carlo uncertainty surface (``settings.h:118-175``:
num_trials, quantiles, bins): the expression tape draws ``num_trials``
probability vectors in one vectorized pass on the analysis device
(``compiler/expr_tape.py``), the whole batch goes through the top-event
evaluator at once (on CUDA the exact-BDD stream kernel, or without a BDD
``make_propagator``'s kernels), and statistics reduce on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import CompiledTree
from ..ops.prng import fold_in, prng_key
from ..utils.profiling import COUNTERS, span, to_host
from .propagate import make_propagator

__all__ = ["UncertaintyResult", "uncertainty_analysis",
           "sample_basic_probabilities"]


@dataclasses.dataclass
class UncertaintyResult:
    mean: float
    std: float
    error_factor: float          # p95 / median (lognormal-style EF).
    quantiles: np.ndarray        # (num_quantiles,) evenly spaced quantiles.
    histogram_edges: np.ndarray  # (num_bins + 1,)
    histogram_density: np.ndarray  # (num_bins,)
    n_trials: int

    def confidence_interval(self, level: float = 0.95) -> tuple[float, float]:
        lo = (1.0 - level) / 2.0
        qs = np.linspace(0.0, 1.0, len(self.quantiles))
        return (float(np.interp(lo, qs, self.quantiles)),
                float(np.interp(1.0 - lo, qs, self.quantiles)))


def sample_basic_probabilities(tape: ExpressionTape, key, n_trials: int,
                               mission_time: float, device,
                               clip_probability: bool = True
                               ) -> torch.Tensor:
    """(n_trials, n_basic) sampled probability vectors on ``device``,
    drawn under the threefry key ``key``."""
    with span("uncertainty.sample"):
        samples = tape.sample(key, n_trials, mission_time, device)
        if clip_probability:
            samples = torch.clamp(samples, 0.0, 1.0)
    return samples


def uncertainty_analysis(tree: CompiledTree, tape: ExpressionTape,
                         seed: int, n_trials: int, mission_time: float,
                         device, num_quantiles: int = 20,
                         num_bins: int = 20,
                         house_states: np.ndarray | None = None,
                         batch_size: int | None = None,
                         top_fn=None) -> UncertaintyResult:
    """Distribution of the top-event probability under parameter uncertainty.

    The run's key is ``prng_key(seed)``, the JAX package's
    ``PRNGKey(seed)``.  ``batch_size`` splits the trials axis into chunks;
    batch ``b`` draws under ``fold_in(key, b)``, as the JAX package's
    batches do, so a batch's samples do not depend on how many batches
    there are (an unbatched run draws under the key itself).  ``top_fn(p_batch) -> (trials,)`` overrides the
    evaluator (e.g. exact BDD evaluation); by default
    :func:`~.propagate.make_propagator` dispatches (the stream kernel on
    CUDA, gather on the CPU) with ``house_states`` (default:
    the tree's) baked in.
    """
    with span("uncertainty"):
        if top_fn is None:
            house = tree.house_state_vector() if house_states is None \
                else np.asarray(house_states)
            top_fn = make_propagator(tree, device, output="top",
                                     house_states=house)

        key = prng_key(seed)

        def run_batch(batch_key, batch_trials: int) -> torch.Tensor:
            p = sample_basic_probabilities(tape, batch_key, batch_trials,
                                           mission_time, device)
            with span("uncertainty.evaluate"), torch.no_grad():
                return top_fn(p)

        if batch_size is None or batch_size >= n_trials:
            tops = run_batch(key, n_trials)
        else:
            pieces = []
            remaining = n_trials
            batch_index = 0
            while remaining > 0:
                chunk = min(batch_size, remaining)
                pieces.append(run_batch(fold_in(key, batch_index), chunk))
                remaining -= chunk
                batch_index += 1
            tops = torch.cat(pieces)
        COUNTERS["trials"] += n_trials

        with span("uncertainty.readback"):
            tops = to_host(tops).numpy()
        with span("uncertainty.statistics"):
            qs = np.linspace(0.0, 1.0, num_quantiles)
            quantiles = np.quantile(tops, qs)
            median = float(np.median(tops))
            p95 = float(np.quantile(tops, 0.95))
            hist, edges = np.histogram(tops, bins=num_bins, density=True)
            mean, std = float(tops.mean()), float(tops.std(ddof=1))
    return UncertaintyResult(
        mean=mean, std=std,
        error_factor=(p95 / median if median > 0 else float("inf")),
        quantiles=quantiles, histogram_edges=edges, histogram_density=hist,
        n_trials=n_trials)
