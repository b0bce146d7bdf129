"""Monte Carlo state sampling: the aleatory simulation engine on torch.

``canopy_tpu/engine/sampler.py`` on torch, two engines:

* :func:`sample_top_probability` — float 0/1 states through the gather
  engine (a Bernoulli state is a probability that happens to be 0 or 1,
  and every gate family maps 0/1 inputs to the exact Boolean output);
  simple and differentiable.
* ``ops/bitpack.packed_top_probability`` — 32 trials per word with
  bitwise gate evaluation, sampled by the Philox kernel
  (``ops/bernoulli_kernel.py``): the engine behind the Monte Carlo
  approximation of ``RiskAnalysis``.

States come from threefry keys (``ops/prng.py``), the JAX package's
``jax.random`` keys: the same key gives the JAX package's states.
"""

from __future__ import annotations

import math

import torch

from ..compiler.graph import CompiledTree
from ..ops.prng import uniform
from .propagate import propagate_probability

__all__ = ["sample_states", "sample_top_probability", "monte_carlo_ci"]


def sample_states(key, basic_p: torch.Tensor, n_trials: int) -> torch.Tensor:
    """Bernoulli basic-event states, shape ``(n_trials, n_basic)`` in
    {0., 1.}: ``uniform(key, (n_trials, n_basic)) < basic_p`` (float32 or
    float64, as ``basic_p``), on ``basic_p``'s device.

    ``basic_p`` may itself be batched ``(n_trials, n_basic)`` — epistemic
    and aleatory sampling compose.
    """
    u = uniform(key, (n_trials, basic_p.shape[-1]), basic_p.dtype,
                device=basic_p.device)
    return (u < basic_p).to(basic_p.dtype)


def sample_top_probability(tree: CompiledTree, key,
                           basic_p: torch.Tensor, n_trials: int,
                           house_states: torch.Tensor | None = None):
    """Estimate the top-event probability by state simulation.

    Returns ``(estimate, states_of_top)`` so callers can compute CIs or
    accumulate across batches.
    """
    if house_states is None:
        house_states = torch.as_tensor(tree.house_state_vector(),
                                       device=basic_p.device)
    states = sample_states(key, basic_p, n_trials)
    vals = propagate_probability(tree, states, house_states)
    top = vals[..., tree.top_index]
    return torch.mean(top), top


def monte_carlo_ci(estimate, n_trials: int, z: float = 1.959963984540054):
    """Normal-approximation confidence half-width for a Bernoulli mean
    (a float for a float estimate, a tensor for a tensor)."""
    var = estimate * (1.0 - estimate) / n_trials
    return z * (torch.sqrt(var) if torch.is_tensor(var) else math.sqrt(var))
