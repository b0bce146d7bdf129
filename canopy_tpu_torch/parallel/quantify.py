"""Sharded quantification steps over a ("data", "model") mesh.

The JAX package's ``parallel/quantify.py`` on ``torch.distributed``, one
process per rank.  A JAX step is one program over the global batch; here
every step takes and returns **the calling rank's own shard** (the torch
idiom), and :func:`shard_trials` / :func:`gather_trials` rebuild the
global view where a caller wants it.

Trials shard over the flattened ``("data", "model")`` mesh, as the JAX
package's ``P(("data", "model"))``: rank ``r`` of ``n`` owns the
contiguous block ``[r*T/n, (r+1)*T/n)``.  The cut-set quantifier shards
trials over ``data`` only (``P("data")``): the ranks of one ``model``
group share a trial block and split the products.

* :func:`sharded_uncertainty_step` — exact propagation of the shard
  (torch operations, the JAX version's jnp); no collectives.
* :func:`sharded_cutset_quantifier` — product rows split over ``model``
  (padded to a multiple with dead rows), partial rare-event and ``log1p``
  sums meeting in one ``all_reduce`` over the ``model`` group.
* :func:`sharded_stream_step`, :func:`sharded_replay_step`,
  :func:`sharded_stream_grad_step` — the stream, replay and adjoint
  kernels on the shard (on CUDA ``csrc/stream.cu``, ``csrc/replay.cu``,
  ``csrc/adjoint.cu``; on the CPU their plain versions): pure data
  parallelism, no collectives.

Trial counts: the JAX steps need ``n_trials % (1024 * n_devices) == 0``,
whole ``(8, 128)`` TPU tiles per device.  The port's staged layout is
``(rows, n_trials)`` with one column per trial and no tile, so that
factor is gone; a trial count that does not split evenly over the ranks
still raises ``LogicError`` (in :func:`shard_trials`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..engine.cutset_quantify import CutSetMatrix
from ..engine.propagate import propagate_probability
from ..errors import LogicError
from .distributed import all_gather, all_reduce
from .mesh import axis_size

__all__ = ["sharded_stream_grad_step", "sharded_uncertainty_step",
           "sharded_cutset_quantifier", "sharded_stream_step",
           "sharded_replay_step", "shard_trials", "gather_trials"]


def _axes_view(mesh, axes) -> tuple[int, int, object]:
    """(this rank's index, count, process group) of the sub-mesh over
    ``axes``: every dimension (the flattened mesh: the world, indexed by
    global rank) or one named dimension."""
    names = tuple(mesh.mesh_dim_names)
    axes = names if axes is None else tuple(axes)
    if axes == names:
        coord = mesh.get_coordinate()
        index = 0
        for name, c in zip(names, coord):
            index = index * axis_size(mesh, name) + c
        return index, mesh.size(), None
    if len(axes) == 1 and axes[0] in names:
        return (mesh.get_local_rank(axes[0]), axis_size(mesh, axes[0]),
                mesh.get_group(axes[0]))
    raise LogicError(f"trial axes {axes} of mesh {names}: all of them or "
                     f"one")


def shard_trials(mesh, x, axes=None):
    """This rank's contiguous block of the global batch ``x`` (trials on
    dim 0): the whole mesh by default, or ``axes=("data",)``."""
    index, count, _group = _axes_view(mesh, axes)
    n = x.shape[0]
    if n % count:
        raise LogicError(f"{n} trials do not split evenly over {count} "
                         f"ranks")
    per = n // count
    return x[index * per:(index + 1) * per]


def gather_trials(mesh, local: torch.Tensor, axes=None) -> torch.Tensor:
    """The global batch from every rank's block (inverse of
    :func:`shard_trials`); a collective call on the axes' group."""
    _index, _count, group = _axes_view(mesh, axes)
    return all_gather(local, group)


def _house(house, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(house, dtype=like.dtype, device=like.device)


def sharded_uncertainty_step(tree: CompiledTree, mesh):
    """``(basic_p (T_local, n_basic), house (n_house,)) -> (T_local,)``
    top probabilities of this rank's trial block."""

    def step(basic_p: torch.Tensor, house) -> torch.Tensor:
        vals = propagate_probability(tree, basic_p, _house(house, basic_p))
        return vals[..., tree.top_index]

    return step


def _pad_rows(array: np.ndarray, multiple: int, fill=0):
    rows = array.shape[0]
    padded = -(-rows // multiple) * multiple
    if padded == rows:
        return array
    pad_width = [(0, padded - rows)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width, constant_values=fill)


def sharded_cutset_quantifier(matrix: CutSetMatrix, mesh):
    """``(basic_p (T_data, n_basic)) -> (rare_event, mcub)`` per trial of
    this rank's ``data`` block (``shard_trials(mesh, x, ("data",))``).

    Product rows are split over ``model``: each rank computes partial
    sums over its row block and one ``all_reduce`` over the ``model``
    group completes both reductions.  Rows pad to a multiple of the
    ``model`` size; a masked-off row has product probability 1, so a
    dead-row flag (``alive``) zeroes the padding.  The sum runs in
    another order than on one device: equal within rounding, not bit for
    bit.
    """
    n_model = axis_size(mesh, "model")
    rank = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    idx = _pad_rows(matrix.idx, n_model)
    neg = _pad_rows(matrix.neg, n_model)
    mask = _pad_rows(matrix.mask, n_model)
    alive = np.zeros(idx.shape[0], dtype=bool)
    alive[:matrix.n_products] = True
    rows = idx.shape[0] // n_model
    block = slice(rank * rows, (rank + 1) * rows)
    local = (idx[block].astype(np.int64), neg[block], mask[block],
             alive[block])

    def quantify(basic_p: torch.Tensor):
        idx_l, neg_l, mask_l, alive_l = (
            torch.from_numpy(np.ascontiguousarray(a)).to(basic_p.device)
            for a in local)
        v = basic_p[..., idx_l]                          # (t, r, o)
        v = torch.where(neg_l, 1.0 - v, v)
        v = torch.where(mask_l, v, 1.0)
        q = torch.prod(v, dim=-1) * alive_l.to(basic_p.dtype)
        partial = torch.stack([
            torch.sum(q, dim=-1),
            torch.sum(torch.log1p(-torch.clamp(q, max=1.0 - 1e-18)),
                      dim=-1)])
        all_reduce(partial, group)
        return torch.clamp(partial[0], max=1.0), -torch.expm1(partial[1])

    return quantify


def _stream_encoding(program):
    from ..ops.stream_kernel import EncodedStream, encode_stream
    return program if isinstance(program, EncodedStream) \
        else encode_stream(program)


def sharded_stream_step(program, mesh, house_states):
    """``(basic_p (T_local, n_basic)) -> (T_local,)`` tops of this rank's
    trials through the stream kernel.

    ``program``: an ``EncodedStream`` (or a ``StreamProgram``, encoded
    here).  Stages the shard (``stage_basic``, f32), then runs
    ``stream_propagate_staged``: the step kernel of ``csrc/stream.cu`` on
    CUDA, its plain version on the CPU.  Each trial is computed alone, so
    the tops are bit-equal to one unsharded call on the same trials.
    """
    from ..ops.stream_kernel import stage_basic, stream_propagate_staged
    enc = _stream_encoding(program)

    def step(basic_p: torch.Tensor) -> torch.Tensor:
        return stream_propagate_staged(enc, stage_basic(enc, basic_p),
                                       house_states)

    return step


def sharded_replay_step(program, mesh, house_states):
    """``(basic_p (T_local, n_basic)) -> (T_local,)`` tops of this rank's
    trials through the replay kernel.

    ``program``: an ``EncodedReplay`` (or a ``ReplayProgram``, encoded
    here).  Stages the shard's basic replay stream (``stage_replay``),
    then runs ``replay_propagate_staged``: ``csrc/replay.cu`` on CUDA.
    """
    from ..ops.stream_kernel import (EncodedReplay, encode_replay,
                                     replay_propagate_staged, stage_replay)
    enc = program if isinstance(program, EncodedReplay) \
        else encode_replay(program)

    def step(basic_p: torch.Tensor) -> torch.Tensor:
        return replay_propagate_staged(enc, stage_replay(enc, basic_p),
                                       house_states)

    return step


def sharded_stream_grad_step(program, mesh, house_states,
                             dtype: torch.dtype = torch.float32):
    """``(basic_p (T_local, n_basic)) -> (tops (T_local,), grad (T_local,
    n_basic))``: each trial's top and its gradient with respect to the
    trial's basic probabilities.

    The JAX step takes a ``compile_adjoint`` program, which the port has
    no use for (its adjoint runs on the stream program's own tables), so
    this one takes the ``EncodedStream``.  It differentiates
    ``ops/adjoint_kernel.make_differentiable_stream`` with
    ``torch.autograd`` on the shard staged in ``dtype`` (f32, or f64 for
    a reference): on CUDA the level-parallel
    logged forward of ``csrc/stream.cu`` and the gather-form backward of
    ``csrc/adjoint.cu``.  The staged cotangent maps back to the basics by
    ``unstage_basic`` (staging is a permutation), as the JAX version's.
    """
    from ..ops.adjoint_kernel import make_differentiable_stream
    from ..ops.stream_kernel import stage_basic, unstage_basic
    enc = _stream_encoding(program)
    f = make_differentiable_stream(enc, house_states)

    def step(basic_p: torch.Tensor):
        staged = stage_basic(enc, basic_p.detach(), dtype).requires_grad_()
        with torch.enable_grad():
            tops = f(staged)
            (g_staged,) = torch.autograd.grad(tops, staged,
                                              torch.ones_like(tops))
        return tops.detach(), unstage_basic(enc, g_staged, basic_p.shape[1])

    return step
