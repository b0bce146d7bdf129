"""Row-partitioned gate propagation: the tensor-parallel compute path.

The JAX package's ``parallel/partition.py`` on ``torch.distributed``: the
gate-structure matrix is **row-partitioned over the mesh's ``model``
axis** — each rank owns a block of every level's gates — while the
trials axis is split over ``data``.  Per level, each rank:

1. evaluates its row block against its (replicated) copy of the value
   matrix with the gather engine's own evaluators
   (``engine/propagate._eval_prod``/``_eval_pair``/``_eval_count``, so
   every gate is computed as one device computes it), then
2. exchanges the *newly produced gate rows only* with an
   ``all_gather_into_tensor`` over the ``model`` group — the halo
   exchange; level outputs are contiguous row ranges, so the gathered
   block drops into the value matrix as one row range.

Padding rows (to make blocks divisible) repeat row 0 and are cut off
after the gather.  Every rank runs the same plan, so every rank makes
the same collective calls in the same order.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..engine.propagate import _EVALUATORS
from ..errors import LogicError
from .distributed import all_gather
from .mesh import axis_size

__all__ = ["make_partitioned_propagator"]


def _pad_rows(array: np.ndarray, multiple: int) -> np.ndarray:
    rows = array.shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return array
    reps = [array[:1]] * (target - rows)
    return np.concatenate([array] + reps, axis=0)


@dataclasses.dataclass
class _PaddedLevel:
    kind: str                 # "prod" | "pair" | "count"
    out_start: int
    n_real: int
    arrays: tuple             # family-specific numpy arrays, row-padded
    aux: tuple = ()


def _plan_levels(tree: CompiledTree, n_model: int) -> list[_PaddedLevel]:
    plan: list[_PaddedLevel] = []
    for level in tree.levels:
        for kind, b in level.iter_blocks():
            if not b.n_gates:
                continue
            if kind == "prod":
                plan.append(_PaddedLevel(
                    "prod", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_flip, n_model),
                     _pad_rows(b.arg_mask, n_model),
                     _pad_rows(b.inv_out[:, None], n_model))))
            elif kind == "pair":
                plan.append(_PaddedLevel(
                    "pair", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_neg, n_model),
                     _pad_rows(b.is_iff[:, None], n_model))))
            else:
                plan.append(_PaddedLevel(
                    "count", int(b.out_idx[0]), b.n_gates,
                    (_pad_rows(b.arg_idx, n_model),
                     _pad_rows(b.arg_neg, n_model),
                     _pad_rows(b.arg_mask, n_model),
                     _pad_rows(b.min_num[:, None], n_model),
                     _pad_rows(b.max_num[:, None], n_model)),
                    aux=(b.cap,)))
    return plan


def _local_block(entry: _PaddedLevel, rank: int, n_model: int):
    """This rank's rows of a padded level as the block the gather
    engine's evaluator of its family reads."""
    rows = entry.arrays[0].shape[0] // n_model
    a = [x[rank * rows:(rank + 1) * rows] for x in entry.arrays]
    if entry.kind == "prod":
        return types.SimpleNamespace(arg_idx=a[0], arg_flip=a[1],
                                     arg_mask=a[2], inv_out=a[3][:, 0])
    if entry.kind == "pair":
        return types.SimpleNamespace(arg_idx=a[0], arg_neg=a[1],
                                     is_iff=a[2][:, 0])
    return types.SimpleNamespace(arg_idx=a[0], arg_neg=a[1], arg_mask=a[2],
                                 min_num=a[3][:, 0], max_num=a[4][:, 0],
                                 cap=entry.aux[0])


def make_partitioned_propagator(tree: CompiledTree, mesh):
    """``(basic_p (T_data, n_basic), house (n_house,)) -> top (T_data,)``
    for this rank's ``data`` block of trials
    (``shard_trials(mesh, x, ("data",))``).

    Gate rows split over ``model`` (one halo all-gather per level block);
    the tops equal the single-device gather engine's
    (``engine/propagate.top_event_probability``) bit for bit: the same
    evaluators on the same rows, and a gather moves values unchanged.
    """
    n_model = axis_size(mesh, "model")
    rank = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    for level in tree.levels:
        for _kind, b in level.iter_blocks():
            if b.n_gates and not np.array_equal(b.out_idx, np.arange(
                    b.out_idx[0], b.out_idx[0] + b.n_gates)):
                raise LogicError("a level block's outputs are not one "
                                 "contiguous row range")
    plan = _plan_levels(tree, n_model)
    blocks = [_local_block(entry, rank, n_model) for entry in plan]

    def propagate(basic_p: torch.Tensor, house) -> torch.Tensor:
        if basic_p.shape[-1] != tree.n_basic:
            raise LogicError(f"the tree has {tree.n_basic} basic events, "
                             f"got {basic_p.shape[-1]} columns")
        basic_nm = basic_p.T
        B = basic_nm.shape[-1]
        house_nm = torch.as_tensor(house, device=basic_p.device)
        parts = [basic_nm]
        if tree.n_house:
            parts.append(torch.broadcast_to(house_nm[:, None],
                                            (tree.n_house, B))
                         .to(basic_nm.dtype))
        parts.append(basic_nm.new_zeros((tree.n_gates, B)))
        vals = torch.cat(parts, dim=0)
        for entry, block in zip(plan, blocks):
            out_local = _EVALUATORS[entry.kind](vals, block)
            # Halo exchange: only the new rows travel.
            out_full = all_gather(out_local.to(vals.dtype), group)
            rows = torch.arange(entry.out_start,
                                entry.out_start + entry.n_real,
                                device=vals.device)
            vals = vals.index_copy(0, rows, out_full[:entry.n_real])
        return vals[tree.top_index]

    return propagate
