"""Lognormal parameter samples as ``jax.random`` draws them, in plain torch.

The analysis under test keys its draws as the JAX package does, so the
reference draws the same samples from the same seed and judges every
trial, not a distribution.  Written from the published definitions:

* threefry2x32 with 20 rounds (Salmon et al., SC 2011), the key of a seed
  its high and low 32-bit words (``jax.random.PRNGKey``), ``fold_in(key,
  d)`` the hash of the counter ``(0, d)``;
* ``jax.random.bits`` in the partitionable layout: element ``t`` hashes
  the counter ``(t >> 32, t mod 2^32)`` to ``(b1, b2)``, a 64-bit draw is
  ``b1 << 32 | b2``;
* ``jax.random.uniform`` in float64: the top 52 bits as the mantissa of a
  number in [1, 2), less 1, scaled onto ``[minval, maxval)``;
* ``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` (here torch's ``erfinv``, not XLA's
  polynomial);
* a lognormal deviate by mean, error factor ``EF`` and level ``L``:
  ``sigma = ln(EF) / z`` with ``z`` the standard normal quantile of ``(1
  + L) / 2``, ``mu = ln(mean) - sigma^2 / 2``, the sample ``exp(mu +
  sigma * normal)``.

Deviate numbering follows the expression tape's rule: expressions in
order, each node one slot after its arguments (a constant is one slot),
deviate slot ``s`` drawing under ``fold_in(key, s)``.
"""

from __future__ import annotations

import math
import statistics

import torch

from .mef import Lognormal

__all__ = ["prng_key", "fold_in", "lognormal_block"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    seed = int(seed) & ((1 << 64) - 1)
    return seed >> 32, seed & _M32


def fold_in(key, data: int) -> tuple[int, int]:
    return _threefry(key[0], key[1], 0, int(data) & _M32)


def _normal(key, t: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of elements ``t`` (int64) under ``key``."""
    b1, b2 = _threefry(key[0], key[1], t >> 32, t & _M32)
    mantissa = (b1 << 20) | (b2 >> 12)
    u = (mantissa | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = math.nextafter(-1.0, 0.0)
    u = torch.clamp(u * (1.0 - lo) + lo, min=lo)
    return math.sqrt(2.0) * torch.special.erfinv(u)


def _slots(expressions) -> list:
    """Tape slot of each expression's deviate (None for a constant)."""
    slots, n = [], 0
    for expr in expressions:
        if isinstance(expr, Lognormal):
            n += 3
            slots.append(n)
            n += 1
        else:
            slots.append(None)
            n += 1
    return slots


def lognormal_block(expressions, key, n_trials: int, device,
                    chunk: int = 1 << 15) -> torch.Tensor:
    """(n_trials, len(expressions)) float64 samples, clipped to [0, 1]."""
    out = torch.empty((n_trials, len(expressions)), dtype=torch.float64,
                      device=device)
    cols, keys, mus, sigmas = [], [], [], []
    for j, (expr, slot) in enumerate(zip(expressions, _slots(expressions))):
        if slot is None:
            out[:, j] = min(max(expr, 0.0), 1.0)
            continue
        z_level = statistics.NormalDist().inv_cdf((1.0 + expr.level) / 2.0)
        sigma = math.log(expr.error_factor) / z_level
        cols.append(j)
        keys.append(fold_in(key, slot))
        mus.append(math.log(expr.mean) - sigma * sigma / 2.0)
        sigmas.append(sigma)
    if not cols:
        return out.clamp_(0.0, 1.0)
    k = torch.tensor(keys, dtype=torch.int64, device=device)
    k0, k1 = k[None, :, 0], k[None, :, 1]
    mu = torch.tensor(mus, dtype=torch.float64, device=device)
    sigma = torch.tensor(sigmas, dtype=torch.float64, device=device)
    cols = torch.tensor(cols, device=device)
    step = max(1, chunk * 256 // len(keys))
    for t0 in range(0, n_trials, step):
        t = torch.arange(t0, min(t0 + step, n_trials), dtype=torch.int64,
                         device=device)[:, None]
        out[t0:t0 + t.shape[0], cols] = torch.exp(mu + sigma *
                                                  _normal((k0, k1), t))
    return out.clamp_(0.0, 1.0)
