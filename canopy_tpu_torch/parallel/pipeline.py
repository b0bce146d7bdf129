"""Pipeline parallelism over gate levels (GPipe-style, on a "pipe" axis).

The JAX package's ``parallel/pipeline.py`` on ``torch.distributed``: the
level schedule is split into contiguous *stages* balanced by nnz, each
stage owned by one rank along the mesh's ``pipe`` axis; the trials axis
is split into *microbatches* that flow through the stages.  At steady
state every stage computes a different microbatch — deep trees stop
serializing the whole mesh on one level at a time.

The microcode is the JAX module's: per (stage, level) an ELL block of
``(G_max, F_max)`` argument slots, padded rows writing to the
out-of-range slot ``n_nodes``.  A rank reads its own stage's slice and
evaluates only the real rows of each level (its padded rows would be
dropped).  Per step, the in-flight value buffer ``(n_nodes, T_micro)``
moves one stage on with ``batch_isend_irecv`` (stage 0 loads a fresh
microbatch each step, so nothing travels back to it); the last stage
collects the tops, and one ``broadcast`` over the ``pipe`` group shares
them (the JAX version's final ``psum``).

Products are taken in the gather engine's order (arguments in column
order, padding multiplies by exactly 1), so the tops equal the
single-device ``engine/propagate.top_event_probability`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.graph import CompiledTree
from ..engine.propagate import _eval_prod
from ..errors import LogicError
from .distributed import broadcast, shift
from .mesh import _world_mesh, axis_size

__all__ = ["make_pipeline_propagator", "make_pipe_mesh", "plan_stages"]


def make_pipe_mesh(device="cuda", pipe: int | None = None, data: int = 1):
    """A ("data", "pipe") mesh over the initialized world; default: every
    rank on the pipe axis.  Collective call."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if pipe is None:
        pipe = world // data
    return _world_mesh(device, (data, pipe), ("data", "pipe"))


@dataclasses.dataclass
class _LevelCode:
    out_start: int
    n_gates: int
    arg_idx: np.ndarray    # (G, F)
    arg_flip: np.ndarray
    arg_mask: np.ndarray
    inv_out: np.ndarray    # (G,)

    @property
    def nnz(self) -> int:
        return int(self.arg_mask.sum())


def _merge_level(level) -> _LevelCode:
    from ..compiler.graph import merge_prod_level

    merged = merge_prod_level(level)
    return _LevelCode(int(merged.out_idx[0]), merged.n_gates,
                      merged.arg_idx, merged.arg_flip, merged.arg_mask,
                      merged.inv_out)


def plan_stages(tree: CompiledTree, n_stages: int) -> list[list[_LevelCode]]:
    """Split the level schedule into ``n_stages`` contiguous chunks with
    (approximately) balanced nnz: boundaries at the ideal cumulative-nnz
    split points."""
    codes = [_merge_level(level) for level in tree.levels
             if any(b.n_gates for b in level.prods)]
    if not codes:
        raise LogicError("tree has no gate levels")
    cum = np.cumsum([c.nnz for c in codes], dtype=np.float64)
    total = cum[-1]
    bounds = [0]
    for s in range(1, n_stages):
        b = int(np.searchsorted(cum, total * s / n_stages))
        bounds.append(max(b, bounds[-1]))
    bounds.append(len(codes))
    return [codes[bounds[s]:bounds[s + 1]] for s in range(n_stages)]


def _microcode(tree: CompiledTree, stages: list[list[_LevelCode]]):
    """The padded microcode ``(S, L_max, G_max[, F_max])``: padded rows
    scatter to slot ``n_nodes``, padded levels have no real rows."""
    n_stages = len(stages)
    l_max = max(len(chunk) for chunk in stages)
    g_max = max((c.n_gates for chunk in stages for c in chunk), default=1)
    f_max = max((c.arg_idx.shape[1] for chunk in stages for c in chunk),
                default=1)
    n_nodes = tree.n_nodes
    out_slots = np.full((n_stages, l_max, g_max), n_nodes, dtype=np.int32)
    arg_idx = np.zeros((n_stages, l_max, g_max, f_max), dtype=np.int32)
    arg_flip = np.zeros((n_stages, l_max, g_max, f_max), dtype=bool)
    arg_mask = np.zeros((n_stages, l_max, g_max, f_max), dtype=bool)
    inv_out = np.zeros((n_stages, l_max, g_max), dtype=bool)
    for s, chunk in enumerate(stages):
        for j, code in enumerate(chunk):
            g, f = code.arg_idx.shape
            out_slots[s, j, :g] = code.out_start + np.arange(g)
            arg_idx[s, j, :g, :f] = code.arg_idx
            arg_flip[s, j, :g, :f] = code.arg_flip
            arg_mask[s, j, :g, :f] = code.arg_mask
            inv_out[s, j, :g] = code.inv_out
    return out_slots, arg_idx, arg_flip, arg_mask, inv_out


def make_pipeline_propagator(tree: CompiledTree, mesh,
                             n_micro: int | None = None,
                             axis: str = "pipe"):
    """``(basic_p (T_data, n_basic), house (n_house,)) -> top (T_data,)``
    for this rank's ``data`` block of trials
    (``shard_trials(mesh, x, ("data",))``; the whole batch when the mesh
    has no ``data`` extent).

    ``T_data`` must be divisible by ``n_micro``, which defaults to 2x the
    stage count (half-bubble at steady state).  Prod-family trees only,
    as the JAX version.
    """
    if tree.top_index is None:
        raise LogicError("tree has no top index")
    n_stages = axis_size(mesh, axis)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = n_micro or 2 * n_stages
    slots, aidx, aflip, amask, ainv = (
        a[stage] for a in _microcode(tree, plan_stages(tree, n_stages)))
    n_nodes = tree.n_nodes
    # The real rows of each of this stage's levels, as the gather engine's
    # prod evaluator reads them (its padded rows would be dropped).
    levels = []
    for j in range(slots.shape[0]):
        g = int((slots[j] < n_nodes).sum())
        if g:
            levels.append((slots[j, :g].astype(np.int64),
                           types.SimpleNamespace(
                               arg_idx=aidx[j, :g], arg_flip=aflip[j, :g],
                               arg_mask=amask[j, :g], inv_out=ainv[j, :g])))
    ranks = dist.get_process_group_ranks(group)
    nxt = ranks[stage + 1] if stage + 1 < n_stages else None
    prev = ranks[stage - 1] if stage > 0 else None

    def propagate(basic_p: torch.Tensor, house) -> torch.Tensor:
        if basic_p.shape[-1] != tree.n_basic:
            raise LogicError(f"the tree has {tree.n_basic} basic events, "
                             f"got {basic_p.shape[-1]} columns")
        basic_nm = basic_p.T
        dev, dtype = basic_p.device, basic_p.dtype
        t_local = basic_nm.shape[1]
        if t_local % n_micro:
            raise LogicError(
                f"trials per data shard ({t_local}) must be divisible by "
                f"n_micro ({n_micro})")
        t_micro = t_local // n_micro
        house_nm = torch.as_tensor(house, device=dev)
        outs = [torch.from_numpy(out).to(dev) for out, _block in levels]

        def fresh(m: int) -> torch.Tensor:
            parts = [basic_nm[:, m * t_micro:(m + 1) * t_micro]]
            if tree.n_house:
                parts.append(torch.broadcast_to(
                    house_nm[:, None], (tree.n_house, t_micro)).to(dtype))
            parts.append(basic_nm.new_zeros((tree.n_gates, t_micro)))
            return torch.cat(parts, dim=0)

        buf = basic_nm.new_zeros((n_nodes, t_micro))
        collected = basic_nm.new_zeros((n_micro, t_micro))
        for t in range(n_micro + n_stages - 1):
            if stage == 0:
                buf = fresh(min(t, n_micro - 1))
            for out, (_rows, block) in zip(outs, levels):
                buf = buf.index_copy(0, out, _eval_prod(buf, block).to(dtype))
            m_out = t - (n_stages - 1)
            if stage == n_stages - 1 and m_out >= 0:
                collected[m_out] = buf[tree.top_index]
            # The buffer moves one stage on.
            recv = torch.empty_like(buf) if prev is not None else None
            shift(buf if nxt is not None else None, nxt, recv, prev)
            if recv is not None:
                buf = recv
        # Only the last stage holds real results; share them.
        broadcast(collected, n_stages - 1, group)
        return collected.reshape(t_local)

    return propagate
