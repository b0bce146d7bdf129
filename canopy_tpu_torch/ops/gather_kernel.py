"""Level-gather propagation: CUDA level kernel and plain version.

The counterpart of ``canopy_tpu/ops/gather_kernel.py`` (``gather_propagate``,
whose ``_level_kernel`` double-buffers one row DMA per argument on the
TPU).  The value matrix is node-major ``(n_nodes, T)`` float32, trials
contiguous, updated in place level by level; each product block of a
level is one launch of ``csrc/gather.cu`` (a thread per (gate, trial),
trials across the lanes so each row read is coalesced), or one call of
:func:`gather_level_plain`, the plain PyTorch version of the same
arithmetic in the same order.

The JAX kernel ignores ``arg_mask``: on a ragged product block, where the
compiler pads a short argument list with slot 0 (``compiler/graph.py``),
it multiplies basic event 0 into the padded positions.  The port does
not: a padded position multiplies in nothing, as in the gather engine
(``engine/propagate.py``), so the result equals the float32 gather engine
bit for bit on every product-family tree, and the JAX kernel's wherever
the fan-in is uniform.

Product family only, no house events, ``T % 1024 == 0`` (the JAX
package's refusals, raised as ``LogicError``).  No JAX entry point calls
this module: callers use :func:`gather_propagate` directly.

Dispatch.  :func:`gather_level` runs the plain version for a CPU tensor
and the kernel for a CUDA tensor, or raises; ``COUNTERS["launch.gather"]``
counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree, ProdBlock
from ..errors import LogicError
from ..utils.profiling import COUNTERS
from ._build import _raise_on, load_library

__all__ = ["gather_propagate", "gather_supported", "gather_forward_plain",
           "stage_gather", "gather_levels", "gather_level",
           "gather_level_plain"]


def gather_supported(tree: CompiledTree) -> bool:
    """Product-family-only, house-free trees qualify for the kernel."""
    return tree.n_house == 0 and all(
        not level.pairs and not level.counts for level in tree.levels)


def _block_tensors(block: ProdBlock, device) -> tuple:
    """``(idx, flip, mask, inv, out_idx)`` of a product block on
    ``device`` (int32 and uint8), cached on the block per device."""
    cache = block.__dict__.setdefault("_gather_tensors", {})
    key = str(device)
    if key not in cache:
        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
        cache[key] = (t(block.arg_idx, np.int32), t(block.arg_flip, np.uint8),
                      t(block.arg_mask, np.uint8),
                      t(block.inv_out, np.uint8),
                      t(block.out_idx, np.int32))
    return cache[key]


def gather_level_plain(vals: torch.Tensor, block: ProdBlock) -> None:
    """The kernel's arithmetic in plain torch, in place on ``vals``:
    ``acc`` starts at 1 and multiplies in each masked fan-in position's
    literal in ``f`` order."""
    idx, flip, mask, inv, out_idx = _block_tensors(block, vals.device)
    acc = torch.ones((block.n_gates, vals.shape[1]), dtype=vals.dtype,
                     device=vals.device)
    for f in range(idx.shape[1]):
        v = vals[idx[:, f].long()]
        x = torch.where(flip[:, f, None].bool(), 1.0 - v, v)
        acc = torch.where(mask[:, f, None].bool(), acc * x, acc)
    vals[out_idx.long()] = torch.where(inv[:, None].bool(), 1.0 - acc, acc)


def gather_level(vals: torch.Tensor, block: ProdBlock) -> None:
    """One product block in place on the ``(n_nodes, T)`` float32 value
    matrix: :func:`gather_level_plain` for a CPU tensor, ``csrc/gather.cu``
    for a CUDA tensor (or raise)."""
    if vals.dtype != torch.float32 or vals.ndim != 2 \
            or not vals.is_contiguous():
        raise LogicError(f"the gather kernel takes a contiguous (n_nodes, T) "
                         f"float32 matrix, got {tuple(vals.shape)} "
                         f"{vals.dtype}")
    if not block.n_gates:
        return
    rows = int(max(block.arg_idx.max(), block.out_idx.max())) + 1
    if vals.shape[0] < rows:
        raise LogicError(f"the block reads and writes rows below {rows}; "
                         f"the matrix has {vals.shape[0]}")
    if vals.device.type != "cuda":
        gather_level_plain(vals, block)
        return
    lib = load_library()
    idx, flip, mask, inv, out_idx = _block_tensors(block, vals.device)
    COUNTERS["launch.gather"] += 1
    code = lib.canopy_gather_level(
        vals.data_ptr(), vals.shape[1], idx.data_ptr(), flip.data_ptr(),
        mask.data_ptr(), inv.data_ptr(), out_idx.data_ptr(), block.n_gates,
        idx.shape[1], torch.cuda.current_stream(vals.device).cuda_stream)
    _raise_on(lib, code, "gather level")


def stage_gather(tree: CompiledTree, basic_p: torch.Tensor) -> torch.Tensor:
    """``(T, n_basic)`` -> the value matrix ``(n_nodes, T)`` float32 on
    ``basic_p``'s device (basic rows, zero gate rows), after the JAX
    package's refusals."""
    if not gather_supported(tree):
        raise LogicError("the gather kernel takes product-family trees "
                         "without house events (use the gather engine)")
    if tree.top_index is None:
        raise LogicError("the gather kernel needs an anchored top event")
    if basic_p.ndim != 2 or basic_p.shape[1] != tree.n_basic:
        raise LogicError(f"the gather kernel takes (T, {tree.n_basic}) "
                         f"probabilities, got {tuple(basic_p.shape)}")
    n_trials = basic_p.shape[0]
    if n_trials % 1024:
        raise LogicError(f"the gather kernel needs T % 1024 == 0, got "
                         f"{n_trials}")
    vals = torch.empty((tree.n_nodes, n_trials), dtype=torch.float32,
                       device=basic_p.device)
    vals[:tree.n_basic].copy_(basic_p.T)
    vals[tree.n_basic:].zero_()
    return vals


def gather_levels(tree: CompiledTree, vals: torch.Tensor) -> torch.Tensor:
    """One :func:`gather_level` per product block of each level, in place
    on a staged value matrix; returns the top row ``(T,)``."""
    for level in tree.levels:
        for block in level.prods:
            gather_level(vals, block)
    return vals[tree.top_index].clone()


def gather_propagate(tree: CompiledTree, basic_p: torch.Tensor
                     ) -> torch.Tensor:
    """``(T, n_basic)`` -> ``(T,)`` float32 top probabilities on
    ``basic_p``'s device."""
    return gather_levels(tree, stage_gather(tree, basic_p))


def gather_forward_plain(tree: CompiledTree, basic_p: torch.Tensor
                         ) -> torch.Tensor:
    """:func:`gather_propagate` through :func:`gather_level_plain` on any
    device (the reference the kernel is held to on the card)."""
    vals = stage_gather(tree, basic_p)
    for level in tree.levels:
        for block in level.prods:
            if block.n_gates:
                gather_level_plain(vals, block)
    return vals[tree.top_index].clone()
