"""Scalar gate arithmetic of the host interpreters.

A copy of ``_f32``, ``_gate_scalar`` and ``_bgate_partials`` from
``canopy_tpu/compiler/adjoint.py``, the stream adjoint's schedule
builder, which the port does not carry (its value-log design needs no
adjoint schedule).  ``compiler/replay_adjoint.simulate_replay_adjoint``
imports them from here; ``tests/test_torch_host.py`` holds each function
to the original.
"""

from __future__ import annotations

import numpy as np


def _f32(x):
    return np.float32(x)


def _gate_scalar(read, kind, locs, aux):
    one = _f32(1.0)
    if kind == "prod":
        acc = one
        for loc, flip in locs:
            v = read(loc)
            acc = acc * ((one - v) if flip else v)
        return one - acc if aux else acc
    if kind == "pair":
        (l0, f0), (l1, f1) = locs
        a = one - read(l0) if f0 else read(l0)
        b = one - read(l1) if f1 else read(l1)
        x = a + b - _f32(2.0) * a * b
        return one - x if aux else x
    if kind == "mux":
        (lp, _), (lh, _), (ll, _) = locs
        p = read(lp)
        return p * read(lh) + (one - p) * read(ll)
    if kind == "fill":
        return _f32(aux)
    lo, hi = aux
    cap = hi + 1
    dp = [one] + [_f32(0.0)] * cap
    for loc, neg in locs:
        v = read(loc)
        if neg:
            v = one - v
        new = [dp[0] * (one - v)]
        for k in range(1, cap):
            new.append(dp[k] * (one - v) + dp[k - 1] * v)
        new.append(dp[cap] + dp[cap - 1] * v)
        dp = new[:cap] + [new[cap]]
    return _f32(sum(dp[k] for k in range(lo, hi + 1)))


def _bgate_partials(kind, xs, aux):
    """d out / d x_i in float64 (host reference), xs post-complement."""
    F = len(xs)
    if kind == "prod":
        parts = []
        for i in range(F):
            p = 1.0
            for j in range(F):
                if j != i:
                    p *= xs[j]
            parts.append(-p if aux else p)
        return parts
    if kind == "pair":
        s = -1.0 if aux else 1.0
        return [s * (1.0 - 2.0 * xs[1]), s * (1.0 - 2.0 * xs[0])]
    if kind == "mux":
        p, hi, lo = xs
        return [hi - lo, p, 1.0 - p]
    lo_n, hi_n = aux
    parts = []
    for i in range(F):
        dp = [1.0]
        for j in range(F):
            if j == i:
                continue
            v = xs[j]
            new = [dp[0] * (1.0 - v)]
            for k in range(1, len(dp)):
                new.append(dp[k] * (1.0 - v) + dp[k - 1] * v)
            new.append(dp[-1] * v)
            dp = new
        def mass(a, b):
            return sum(dp[k] for k in range(max(a, 0), min(b, len(dp) - 1) + 1))
        parts.append(mass(lo_n - 1, hi_n - 1) - mass(lo_n, hi_n))
    return parts
