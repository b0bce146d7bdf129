"""The yardstick's arithmetic, frozen: one NVIDIA H100 SXM at its full
700 W (NVIDIA's data sheet), and the work of the kernels the cells time.

A kernel's roofline share is the least time the card could take for the
work (the larger of the operations over their peak rate and the bytes
over the memory rate) over the time the profiler measured.  The work
counts of a configuration live in its file, frozen as numbers, so the
share reads the same work whatever implements it.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS_F32", "PEAK_FLOPS_F64",
           "N_SMS", "ALU_LANES", "SM_CLOCK_HZ", "THREEFRY_INT_OPS",
           "bound_s", "stream_bound_s", "sampler_bound_s"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_F64 = 34e12
#: SMs of the card, 32-bit logical and integer operations per SM and clock
#: on the ALU pipe, and the boost clock.
N_SMS = 132
ALU_LANES = 64
SM_CLOCK_HZ = 1.98e9
#: Integer operations of one threefry2x32 call: two key additions, 20
#: rounds of an add, a rotate and a XOR, five key injections of two adds.
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2


def bound_s(n_bytes: float, seconds_of_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, seconds_of_ops)


def stream_bound_s(work: dict, n_trials: int) -> float:
    """The BDD stream program over ``n_trials`` trials in float32: its
    operations at the float32 peak against the basic events' float32
    probabilities read once and each module's value written once."""
    flops = work["stream_flops_per_trial"] * n_trials
    n_bytes = 4 * (work["n_basic"] + work["n_modules"]) * n_trials
    return bound_s(n_bytes, flops / PEAK_FLOPS_F32)


def sampler_bound_s(work: dict, n_trials: int) -> float:
    """``n_trials`` draws of each sampled basic event: threefry's integer
    operations on the ALU lanes against the float64 table written."""
    draws = work["n_sampled"] * n_trials
    int_s = draws * THREEFRY_INT_OPS / (ALU_LANES * N_SMS * SM_CLOCK_HZ)
    return bound_s(8 * draws, int_s)
