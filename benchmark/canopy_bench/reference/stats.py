"""The statistics an analysis reports over its trials, in float64.

Definitions as SCRAM's uncertainty report gives them: the mean, the
sample standard deviation, ``num_quantiles`` evenly spaced quantiles
(linear interpolation), the 95 % interval read off those quantiles, the
error factor as the 95th percentile over the median, and a density
histogram of ``num_bins`` equal bins over the range.
"""

from __future__ import annotations

import numpy as np

__all__ = ["top_stats"]


def _error_factor(x: np.ndarray) -> float:
    median = float(np.median(x))
    p95 = float(np.quantile(x, 0.95))
    return p95 / median if median > 0 else float("inf")


def top_stats(tops: np.ndarray, num_quantiles: int, num_bins: int) -> dict:
    x = np.asarray(tops, dtype=np.float64)
    qs = np.linspace(0.0, 1.0, num_quantiles)
    quantiles = np.quantile(x, qs)
    density, edges = np.histogram(x, bins=num_bins, density=True)
    return {"mean": float(x.mean()), "std": float(x.std(ddof=1)),
            "error_factor": _error_factor(x),
            "ci95": [float(np.interp(0.025, qs, quantiles)),
                     float(np.interp(0.975, qs, quantiles))],
            "n_trials": int(len(x)), "quantiles": quantiles.tolist(),
            "histogram_edges": edges.tolist(),
            "histogram_density": density.tolist()}
