"""Bottom-up probability propagation over the compiled gate graph.

The gather engine of ``canopy_tpu/engine/propagate.py`` on torch: given
per-basic-event probabilities (optionally batched over a trials axis) and
house-event states, propagate through the level schedule to get every
gate's probability under the independence assumption.

Memory layout is **node-major**: the working value matrix is
``(n_nodes, n_trials)``, so each argument fetch is a contiguous row; the
batch-leading public API transposes at the boundary.

Per level (see ``compiler/graph.py``):

* ``prod`` family — one row gather per fan-in column, one fused
  conditional complement, one product, one row-block write;
* ``pair`` family — closed-form xor/iff on two gathered rows;
* ``count`` family — a Poisson-binomial dynamic program over the fan-in
  axis carrying a count distribution with an absorbing cap.

Rows are written out of place (``index_copy``), so autograd differentiates
the whole pass.  Exact when no basic event feeds two argument paths of the
same gate subgraph; the BDD engine (``engine/bdd_eval.py``) is the exact
path for shared-event models.  The kernel engines (``make_propagator`` and
its staged and parameter variants) are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..compiler.graph import CompiledTree, CountBlock, PairBlock, ProdBlock

__all__ = ["propagate_probability", "top_event_probability",
           "propagate_node_major", "mean_basic_probabilities"]


def _compute_dtype(vals: torch.Tensor) -> torch.dtype:
    """Gate math runs in >= f32 even when the value matrix is stored
    narrow; one rounding per level instead of one per multiply."""
    return torch.promote_types(vals.dtype, torch.float32)


def _t(array, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _eval_prod(vals: torch.Tensor, block: ProdBlock):
    """vals: (n_nodes, B). Returns out (G, B), one fan-in column at a
    time (never materializing the (G, F, B) tensor)."""
    F = block.arg_idx.shape[1]
    cdt = _compute_dtype(vals)
    dev = vals.device
    acc = None
    for f in range(F):
        v = vals[_t(block.arg_idx[:, f].astype(np.int64), dev)].to(cdt)
        flip = _t(block.arg_flip[:, f], dev)[:, None]
        x = torch.where(flip, 1.0 - v, v)
        if not block.arg_mask[:, f].all():
            mask = _t(block.arg_mask[:, f], dev)[:, None]
            x = torch.where(mask, x, 1.0)                # Neutral pad.
        acc = x if acc is None else acc * x
    return torch.where(_t(block.inv_out, dev)[:, None], 1.0 - acc, acc)


def _eval_pair(vals: torch.Tensor, block: PairBlock):
    dev = vals.device
    v = vals[_t(block.arg_idx.astype(np.int64), dev)].to(
        _compute_dtype(vals))                          # (G, 2, B)
    neg = _t(block.arg_neg, dev)[..., None]
    v = torch.where(neg, 1.0 - v, v)
    a, b = v[:, 0, :], v[:, 1, :]
    xor = a + b - 2.0 * a * b
    return torch.where(_t(block.is_iff, dev)[:, None], 1.0 - xor, xor)


def _eval_count(vals: torch.Tensor, block: CountBlock):
    """Poisson-binomial DP with absorbing cap (state ``cap`` = ">= cap")."""
    dev = vals.device
    v = vals[_t(block.arg_idx.astype(np.int64), dev)].to(
        _compute_dtype(vals))                          # (G, F, B)
    neg = _t(block.arg_neg, dev)[..., None]
    mask = _t(block.arg_mask, dev)[..., None]
    v = torch.where(neg, 1.0 - v, v)
    v = torch.where(mask, v, 0.0)                      # Pad: never true.

    cap = block.cap
    G, F, B = v.shape
    dp = v.new_zeros((G, cap + 1, B))
    dp[:, 0, :] = 1.0
    for f in range(F):
        p = v[:, f, :][:, None, :]                     # (G, 1, B)
        shifted = torch.cat([torch.zeros_like(dp[:, :1, :]),
                             dp[:, :-1, :]], dim=1)
        new = dp * (1.0 - p) + shifted * p
        last = new[:, cap, :] + dp[:, cap, :] * p[:, 0, :]
        dp = torch.cat([new[:, :cap, :], last[:, None, :]], dim=1)

    counts = torch.arange(cap + 1, device=dev)
    in_range = ((counts[None, :] >= _t(block.min_num, dev)[:, None]) &
                (counts[None, :] <= _t(block.max_num, dev)[:, None]))
    return torch.sum(torch.where(in_range[..., None], dp, 0.0), dim=1)


_EVALUATORS = {"prod": _eval_prod, "pair": _eval_pair,
               "count": _eval_count}


def propagate_node_major(tree: CompiledTree, basic_nm: torch.Tensor,
                         house_nm: torch.Tensor) -> torch.Tensor:
    """Core pass. ``basic_nm``: (n_basic, B); returns (n_nodes, B)."""
    B = basic_nm.shape[-1]
    parts = [basic_nm]
    if tree.n_house:
        parts.append(torch.broadcast_to(house_nm, (tree.n_house, B))
                     .to(basic_nm.dtype))
    parts.append(basic_nm.new_zeros((tree.n_gates, B)))
    vals = torch.cat(parts, dim=0)
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            if block.n_gates:
                out = _EVALUATORS[kind](vals, block)
                vals = vals.index_copy(
                    0, _t(block.out_idx.astype(np.int64), vals.device),
                    out.to(vals.dtype))
    return vals


def _to_node_major(tree: CompiledTree, basic_p, house_states):
    batch_shape = tuple(basic_p.shape[:-1])
    if tree.n_house:
        batch_shape = tuple(torch.broadcast_shapes(
            batch_shape, tuple(house_states.shape[:-1])))
    B = math.prod(batch_shape) if batch_shape else 1
    basic_p = torch.broadcast_to(basic_p, batch_shape + (tree.n_basic,))
    basic_nm = torch.reshape(basic_p, (B, tree.n_basic)).T
    house_nm = torch.reshape(
        torch.broadcast_to(house_states, batch_shape + (tree.n_house,)),
        (B, tree.n_house)).T if tree.n_house else \
        basic_nm.new_zeros((0, B))
    return basic_nm, house_nm, batch_shape


def propagate_probability(tree: CompiledTree, basic_p: torch.Tensor,
                          house_states: torch.Tensor) -> torch.Tensor:
    """Batch-leading API: (..., n_basic) -> (..., n_nodes)."""
    basic_nm, house_nm, batch_shape = _to_node_major(tree, basic_p,
                                                     house_states)
    vals = propagate_node_major(tree, basic_nm, house_nm)
    return torch.reshape(vals.T, batch_shape + (tree.n_nodes,))


def top_event_probability(tree: CompiledTree, basic_p: torch.Tensor,
                          house_states: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The top event's probability (requires ``tree.top_index``)."""
    if house_states is None:
        house_states = torch.as_tensor(tree.house_state_vector(),
                                       device=basic_p.device)
    basic_nm, house_nm, batch_shape = _to_node_major(tree, basic_p,
                                                     house_states)
    vals = propagate_node_major(tree, basic_nm, house_nm)
    return torch.reshape(vals[tree.top_index], batch_shape)


def mean_basic_probabilities(tree: CompiledTree) -> np.ndarray:
    """Host-side mean probability vector from the MEF expressions."""
    return np.array([event.p() for event in tree.basic_events],
                    dtype=np.float64)
