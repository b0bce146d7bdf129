"""Exact probability evaluation over a level-scheduled ROBDD.

Shannon recursion as batched tensor compute: per level, one gather of
child values + one fused multiply-add per node —

    P(node) = p[var] * P(high) + (1 - p[var]) * P(low)

with terminals pinned to 0/1. Exact for any DAG (shared events included),
batched over a leading trials axis for exact epistemic uncertainty, and
differentiable by autograd for exact Birnbaum importances (the top
probability is multilinear in p, so reverse mode through this evaluator
*is* the exact partial-derivative vector).

On CUDA every BDD whose root is not a constant runs as a stream program
through the hand-written kernels of ``ops/`` (f32 or f64, any trial
count); the level evaluation, which keeps the input dtype (f64 by
default), serves the CPU and single points.  The JAX package streams
only BDDs of at least 256 nodes on its TPU grid; on the card the stream
wins at any size: 64 sequence BDDs of 13 nodes at 2^20 trials took
52.077 ms through the stream kernel against 516.011 ms by the f64 level
evaluation (``chip_smoke.py`` phase 11; NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.bdd import CompiledBdd
from ..utils.profiling import to_device

__all__ = ["bdd_probability", "make_bdd_evaluator",
           "make_modular_evaluator"]


def bdd_probability(bdd: CompiledBdd, basic_p: torch.Tensor) -> torch.Tensor:
    """Top-event probability; ``basic_p``: (..., n_basic); returns (...)."""
    batch_shape = basic_p.shape[:-1]
    if bdd.n_nodes == 0:
        value = 1.0 if bdd.root_ptr == 1 else 0.0
        return torch.full(batch_shape, value, dtype=basic_p.dtype,
                          device=basic_p.device)
    vals = torch.cat([
        basic_p.new_zeros(batch_shape + (1,)),
        basic_p.new_ones(batch_shape + (1,)),
        basic_p.new_zeros(batch_shape + (bdd.n_nodes,)),
    ], dim=-1)
    device = basic_p.device
    for level in bdd.levels:
        var_slot, low_ptr, high_ptr, out_ptr = (
            torch.from_numpy(a.astype(np.int64)).to(device) for a in level)
        p = basic_p[..., var_slot]
        lo = vals[..., low_ptr]
        hi = vals[..., high_ptr]
        vals = vals.index_copy(-1, out_ptr, p * hi + (1.0 - p) * lo)
    return vals[..., bdd.root_ptr]


_TAG = {torch.float32: "bdd-stream-f32", torch.float64: "bdd-stream-f64"}


def _stream_call(bdd: CompiledBdd, differentiable: bool,
                 dtype: torch.dtype):
    """``f(values) -> (n_trials,)`` for one BDD's stream program.

    The encoded program is cached on the BDD, so importance (f64,
    differentiable) and uncertainty (f32) schedule and encode it once."""
    from ..ops.adjoint_kernel import make_differentiable_stream
    from ..ops.stream_kernel import (bdd_stream_encoding, stage_basic,
                                     stream_bdd_probability)
    enc = bdd_stream_encoding(bdd)
    if not differentiable:
        return lambda values: stream_bdd_probability(enc, values, dtype)
    f = make_differentiable_stream(enc, np.zeros(0, np.float32))
    return lambda values: f(stage_basic(enc, values, dtype))


def _streams_on(device: torch.device, engine: str) -> bool:
    """Kernel path on CUDA; ``engine="stream"`` forces the same path on
    the CPU through the kernels' plain versions (what the tests use)."""
    return engine == "stream" or (engine == "auto" and
                                  device.type == "cuda")


def make_bdd_evaluator(bdd: CompiledBdd, device, engine: str = "auto",
                       differentiable: bool = False,
                       dtype: torch.dtype = torch.float32):
    """An exact evaluator ``f(basic_p) -> top probability``.

    On CUDA a BDD whose root is not a constant runs (n_trials, n_basic)
    batches through the stream kernel (``ops/stream_kernel.py``); every
    other input takes the
    level-scheduled evaluation above.  ``differentiable=True`` routes the
    stream path through the adjoint kernel so autograd through the
    evaluator runs the backward kernel.  ``dtype`` (float32 or float64)
    is the kernels' value type.  ``.method`` names the compute path and
    its precision (``bdd-stream-f32``, or ``bdd`` for the level
    evaluation), so callers record it instead of silently demoting.
    """
    device = torch.device(device)
    call = None
    if _streams_on(device, engine) and bdd.resolved_root() > 1:
        call = _stream_call(bdd, differentiable, dtype)

    def fn(basic_p):
        if call is not None and basic_p.ndim == 2:
            return call(basic_p)
        return bdd_probability(bdd, basic_p)
    fn.method = _TAG[dtype] if call is not None else "bdd"
    return fn


def make_modular_evaluator(modular, device, engine: str = "auto",
                           differentiable: bool = False,
                           dtype: torch.dtype = torch.float32):
    """An exact evaluator over a modular BDD chain.

    Like :func:`make_bdd_evaluator` but for
    :class:`~canopy_tpu_torch.compiler.modules.ModularBdd`: on CUDA each
    module runs as its own stream-kernel program, reading the decision
    variables it needs (basics + collapsed inner-module outputs) from the
    growing value matrix.  Constant modules fold to their value.  The
    streaming chain runs in ``dtype``; ``.method`` names the path as
    there.
    """
    from ..compiler.modules import modular_probability

    device = torch.device(device)
    steps = None
    if _streams_on(device, engine):
        steps = []
        for bdd, out_slot in modular.chain:
            root = bdd.resolved_root()
            if root <= 1:
                steps.append((float(root), out_slot))
            else:
                steps.append((_stream_call(bdd, differentiable, dtype),
                              out_slot))

    def fn(basic_p):
        if steps is None or basic_p.ndim != 2:
            return modular_probability(modular, basic_p)
        n_trials = basic_p.shape[0]
        vals = torch.cat([
            basic_p.to(dtype),
            basic_p.new_zeros((n_trials, modular.n_nodes - modular.n_basic),
                              dtype=dtype)], dim=-1)
        result = None
        for step, out_slot in steps:
            if isinstance(step, float):
                value = vals.new_full((n_trials,), step)
            else:
                value = step(vals)
            if out_slot == modular.top_index:
                result = value
            # Out of place: autograd needs every earlier matrix intact.
            vals = vals.index_copy(
                1, to_device([out_slot], vals.device, torch.int64),
                value.unsqueeze(1))
        return result
    fn.method = _TAG[dtype] if steps is not None else "bdd"
    return fn
