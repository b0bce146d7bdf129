"""The yardstick of an event tree's evaluation, frozen: the least time
one NVIDIA H100 SXM (``roofline``'s peaks) could take for every sequence
of a request by direct propagation.

The work is the configuration's (``work`` in its file, counted once from
the compiled tree's level blocks): its float64 operations per trial at
the float64 peak, against the basic events' float64 probabilities read
once and each sequence's float64 value written once.  So the share reads
the same work whatever implements the evaluation.
"""

from __future__ import annotations

from .roofline import PEAK_FLOPS_F64, bound_s

__all__ = ["evaluate_bound_s"]


def evaluate_bound_s(work: dict, n_trials: int) -> float:
    flops = work["f64_ops_per_trial"] * n_trials
    n_bytes = 8 * (work["n_basic"] + work["n_sequences"]) * n_trials
    return bound_s(n_bytes, flops / PEAK_FLOPS_F64)
