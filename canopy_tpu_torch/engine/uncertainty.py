"""Epistemic uncertainty analysis: batched sampling + distribution stats.

The reference's Monte-Carlo uncertainty surface (``settings.h:118-175``:
num_trials, quantiles, bins): the expression tape draws ``num_trials``
probability vectors in one vectorized pass on the analysis device
(``compiler/expr_tape.py``), the whole batch goes through the top-event
evaluator at once (on CUDA the exact-BDD stream kernel, or without a BDD
``make_propagator``'s kernels), and the statistics reduce where the tops
live, from one sort of them (:func:`summarize`): one copy of a summary
of fixed size comes back, whatever the number of trials.
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
           "sample_basic_probabilities", "summarize", "OrderStatistics",
           "order_statistics"]


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
        return summarize(tops, num_quantiles, num_bins)


def _neighbours(n: int, q):
    """numpy's "linear" quantile at levels ``q`` in [0, 1] of ``n`` sorted
    values: the positions below and above each virtual index ``(n - 1) q``,
    and the weight between them, in ``q``'s dtype as numpy computes them."""
    virtual = (n - 1) * q
    below = np.floor(virtual)
    gamma = virtual - below
    below = np.minimum(below, n - 1).astype(np.intp)
    return below, np.minimum(below + 1, n - 1), gamma


def _lerp(a, b, t):
    """numpy's ``_lerp``: ``a + (b - a) t``, taken from ``b`` where
    ``t >= 0.5``."""
    diff = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff * t))
    np.subtract(b, diff * (1 - t), out=out, where=t >= 0.5,
                casting="unsafe", dtype=type(out.dtype))
    return out


@dataclasses.dataclass
class OrderStatistics:
    """Each row's statistics from :func:`order_statistics`, one entry a
    row."""

    quantiles: np.ndarray     # (S, len(levels))
    error_factor: np.ndarray  # (S,) p95 / median, inf unless median > 0.
    mean: np.ndarray          # (S,) float64
    std: np.ndarray           # (S,) float64, ddof=1; NaN for one value.
    extra: np.ndarray         # (S, m) float64: the caller's columns.


def order_statistics(rows: torch.Tensor, levels: np.ndarray,
                     extra=None) -> OrderStatistics:
    """Each row of an (S, n) matrix reduced on the matrix's own device
    from one sort along the rows, with one copy of (S, a few) numbers
    back to the host.

    The quantiles at ``levels``, the 95th percentile (at a level in the
    values' dtype, as ``np.quantile`` takes a scalar one) and the median
    equal NumPy's on each row to the bit: the device returns each order
    statistic's neighbours and the host finishes NumPy's interpolation.
    Mean and ``std(ddof=1)`` accumulate in float64 over the rows as
    given.  ``extra(ordered)``, where given, returns (S, m_i) tensors
    computed from the sorted rows on their device; they come back in the
    same copy, as float64 columns of ``extra``.  A reduction on a CUDA
    device counts in ``stats_on_device``."""
    n = rows.shape[1]
    dtype = torch.empty((), dtype=rows.dtype).numpy().dtype
    q_below, q_above, q_gamma = _neighbours(n, levels)
    p_below, p_above, p_gamma = _neighbours(n, np.asarray(0.95, dtype))
    positions = [*q_below, *q_above, p_below, p_above, (n - 1) // 2, n // 2]
    wide = rows.to(torch.float64)
    if n > 1:
        std, mean = torch.std_mean(wide, dim=1, correction=1)
    else:
        mean, std = wide[:, 0], torch.full_like(wide[:, 0], np.nan)
    # NumPy sorts on the host about twenty times faster than torch.
    ordered = torch.sort(rows, dim=1).values if rows.is_cuda else \
        torch.from_numpy(np.sort(rows.numpy(), axis=1))
    # Column views stacked: no index vector goes up to the device.
    picks = torch.stack([ordered[:, int(i)] for i in positions], dim=1)
    columns = [picks, mean[:, None], std[:, None],
               *(extra(ordered) if extra is not None else ())]
    if rows.is_cuda:
        COUNTERS["stats_on_device"] += 1
    with span("uncertainty.readback"):
        packed = to_host(torch.cat(columns, dim=1)).numpy()

    k = len(levels)
    picks = packed[:, :2 * k + 4].astype(dtype)
    p95 = _lerp(picks[:, 2 * k], picks[:, 2 * k + 1], p_gamma)
    median = np.median(picks[:, 2 * k + 2:2 * k + 4 - n % 2], axis=1)
    error_factor = np.full(len(picks), np.inf)
    np.divide(p95, median, out=error_factor, where=median > 0,
              dtype=np.float64)
    return OrderStatistics(
        quantiles=_lerp(picks[:, :k], picks[:, k:2 * k], q_gamma),
        error_factor=error_factor, mean=packed[:, 2 * k + 4],
        std=packed[:, 2 * k + 5], extra=packed[:, 2 * k + 6:])


def summarize(tops: torch.Tensor, num_quantiles: int = 20,
              num_bins: int = 20) -> UncertaintyResult:
    """The distribution of ``tops`` (1-D) by :func:`order_statistics` on
    their own device.  Quantiles, median, the 95th percentile and the
    histogram equal ``np.quantile``, ``np.median`` and
    ``np.histogram(density=True)`` on the same values to the bit: the
    histogram's edges and the trials below each come from the sorted
    values in the same copy, and the host finishes NumPy's arithmetic."""
    n = tops.numel()
    dtype = torch.empty((), dtype=tops.dtype).numpy().dtype

    def histogram(ordered):
        # np.histogram's edges: np.linspace over [min, max] in the values'
        # dtype, an empty range widened by 0.5 each way.  The step divides
        # by a tensor: CUDA divides by a host scalar through its reciprocal.
        lo, hi = ordered[:, :1], ordered[:, -1:]
        half = (lo == hi).to(ordered.dtype) * 0.5
        first, last = lo - half, hi + half
        step = (last - first) / torch.full_like(first, num_bins)
        edges = torch.arange(num_bins + 1, dtype=ordered.dtype,
                             device=ordered.device) * step + first
        edges[:, -1:] = last
        # Trials below each inner edge: bins [e_i, e_i+1), the last closed.
        return edges, torch.searchsorted(ordered, edges[:, 1:-1])

    with span("uncertainty.statistics"):
        stats = order_statistics(tops.unsqueeze(0),
                                 np.linspace(0.0, 1.0, num_quantiles),
                                 histogram)
        edges = stats.extra[0, :num_bins + 1].astype(dtype)
        if not np.isfinite(edges[[0, -1]]).all():
            raise ValueError(f"autodetected range of [{edges[0]}, "
                             f"{edges[-1]}] is not finite")
        below = stats.extra[0, num_bins + 1:].astype(np.intp)
        counts = np.diff(np.concatenate(([0], below, [n])))
        density = counts / np.array(np.diff(edges), float) / counts.sum()
    return UncertaintyResult(
        mean=float(stats.mean[0]), std=float(stats.std[0]),
        error_factor=float(stats.error_factor[0]),
        quantiles=stats.quantiles[0], histogram_edges=edges,
        histogram_density=density, n_trials=n)
