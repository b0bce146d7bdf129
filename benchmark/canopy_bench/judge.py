"""The numbers that decide ``correct``: the program's answers against the
reference's, each reduced to one worst gap.

* ``stat_gap``: the largest relative gap of a reported statistic of a
  top's uncertainty (mean, standard deviation, error factor, the 95 %
  interval, every quantile, every histogram edge);
* ``hist_moved``: the largest share of a request's trials that fall in
  another histogram bin than the reference's.

A missing answer reads infinitely far off.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["rel", "stat_gap", "hist_moved", "worst"]

INF = float("inf")


def rel(a, b) -> float:
    """|a - b| relative to |b| (absolute where b is 0); equal infinities
    are no gap."""
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return INF
    return abs(a - b) / abs(b) if b != 0 else abs(a - b)


def _vector_gap(a, b) -> float:
    a, b = list(a), list(b)
    if len(a) != len(b):
        return INF
    return max((rel(x, y) for x, y in zip(a, b)), default=0.0)


def stat_gap(prog: dict | None, ref: dict) -> float:
    if prog is None or prog.get("n_trials") != ref["n_trials"]:
        return INF
    gaps = [rel(prog[k], ref[k]) for k in ("mean", "std", "error_factor")]
    for k in ("ci95", "quantiles", "histogram_edges"):
        gaps.append(_vector_gap(prog[k], ref[k]))
    return max(gaps)


def _counts(stats: dict) -> np.ndarray:
    edges = np.asarray(stats["histogram_edges"], dtype=np.float64)
    density = np.asarray(stats["histogram_density"], dtype=np.float64)
    return np.rint(density * np.diff(edges) * stats["n_trials"])


def hist_moved(prog: dict | None, ref: dict) -> float:
    if prog is None or len(prog["histogram_density"]) != \
            len(ref["histogram_density"]):
        return INF
    moved = np.abs(_counts(prog) - _counts(ref)).sum() / 2
    return float(moved / ref["n_trials"])


def worst(numbers: dict, name: str, value: float) -> None:
    """Keep the larger reading of ``name``."""
    numbers[name] = max(numbers.get(name, 0.0), value)
