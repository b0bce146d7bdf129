"""Fused whole-tree propagation: CUDA kernel and plain version.

The counterpart of the fused half of ``canopy_tpu/ops/pallas_kernels.py``:
``fused_propagate_tiled`` / ``fused_propagate_tiled_staged`` (the
``_make_tiled_kernel`` body, 1024-trial (8, 128) tiles per node) and
``fused_propagate`` (its lane-row kernel, 128-trial rows).  Both compute
the top event's value per trial, in float32, with the whole tree resident
on chip: gates in ``_emit_gate_ops`` order (level order; prod, pair and
count ops), house states baked in as float32 constants.

On the H100 both are one hand-written kernel, ``csrc/fused.cu``: one
thread per trial walks the tree's encoded op table (the
``csrc/stream_ops.cuh`` format, out row = gate row) with a block's gate
values in shared memory, ``(n_gates, W)`` float32.  The two entry points
differ only in the block width ``W``, which the shared memory one block
may use (232,448 bytes on an H100) trades against the tree's gate count:

============  =================  ==================
Variant       Trials per block   Most gates that fit
============  =================  ==================
tiled         128                454
lane-row      32                 1,816
============  =================  ==================

128 trials are four warps, the narrowest block that still lets the
scheduler overlap warps inside a block; 32 is one warp, the least a
block can run.  The TPU's ``n_trials % 1024`` rule has no counterpart:
any trial count works.  The TPU predicates counted basics too (12 MB of
VMEM held basics and gates); here basics are read straight from device
memory and only gates take shared memory.

Layout.  The staged input is ``(n_basic, n_trials)`` float32 in the
tree's basic order, trials contiguous (:func:`tile_trials`), so a warp's
read of one basic is one coalesced segment; the JAX package's
``(n_tiles, n_basic, 8, 128)`` tiling has no meaning here.

Dispatch.  A wrapper runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor (or raises); ``LAUNCHES["fused_tiled"]`` and
``LAUNCHES["fused"]`` count launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..compiler.schedule import _emit_gate_ops
from ..errors import LogicError
from .stream_kernel import (HOUSE, LAUNCHES, POOL, SMEM_BYTES, STAGED,
                            EncodedStream, _KIND, _check_cuda, _count_row,
                            _dp_scratch, _ptr, _raise_on,
                            house_tensor, stream_forward_plain)

__all__ = ["SMEM_BYTES", "TILED_TRIALS", "LANE_TRIALS", "fused_supported",
           "fused_tiled_supported", "encode_fused", "tile_trials",
           "fused_forward", "fused_forward_plain", "fused_propagate",
           "fused_propagate_tiled", "fused_propagate_tiled_staged"]

#: Trials per block of the tiled counterpart and of the lane-row one.
TILED_TRIALS = 128
LANE_TRIALS = 32


def _fits(tree: CompiledTree, block_trials: int) -> bool:
    return tree.top_index is not None and tree.n_gates > 0 and \
        tree.top_index >= tree.n_basic + tree.n_house and \
        tree.n_gates * block_trials * 4 <= SMEM_BYTES


def fused_supported(tree: CompiledTree) -> bool:
    """True when the tree fits the lane-row counterpart: 32-trial rows, at
    most 1,816 gates, and the top is a gate."""
    return _fits(tree, LANE_TRIALS)


def fused_tiled_supported(tree: CompiledTree) -> bool:
    """True when the tree fits the tiled counterpart: 128-trial rows, at
    most 454 gates."""
    return _fits(tree, TILED_TRIALS)


def encode_fused(tree: CompiledTree) -> EncodedStream:
    """The tree's gates as one op table (cached on the tree).

    Ops follow ``_emit_gate_ops`` (the JAX fused kernels' order); an
    argument is a staged basic row (its basic slot), a house constant or
    a gate row (``slot - n_basic - n_house``), and each op writes its own
    gate row, so the program is a stream program whose pool is the gate
    array and :func:`~.stream_kernel.stream_forward_plain` runs it.
    """
    enc = getattr(tree, "_fused_encoding", None)
    if enc is not None:
        return enc
    n_b, base = tree.n_basic, tree.n_basic + tree.n_house
    ops, args = [], []
    max_states = 0
    for kind, out, gate_args, aux in _emit_gate_ops(tree):
        begin = len(args)
        for slot, flag in gate_args:
            if slot < n_b:
                src, index = STAGED, slot
            elif slot < base:
                src, index = HOUSE, slot - n_b
            else:
                src, index = POOL, slot - base
            args.append([src, index, int(bool(flag)), src, index])
        aux0 = aux1 = 0
        if kind == "count":
            aux0, aux1, states = _count_row(aux, len(gate_args), args, begin)
            max_states = max(max_states, states)
        else:
            aux0 = int(bool(aux))
        ops.append([_KIND[kind], out - base, begin, len(args), aux0, aux1,
                    -1])
    enc = EncodedStream(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.zeros(len(ops), dtype=np.float32), n_log=0, n_basic=n_b,
        n_house=tree.n_house, pool_slots=max(tree.n_gates, 1),
        top_slot=(tree.top_index - base if tree.top_index is not None
                  else -1),
        max_count_states=max_states,
        staged_cols=np.arange(n_b, dtype=np.int64))
    tree._fused_encoding = enc
    return enc


def tile_trials(basic_p: torch.Tensor) -> torch.Tensor:
    """``(n_trials, n_basic)`` -> the kernels' staged input: ``(n_basic,
    n_trials)`` float32, trials contiguous.  One pass over the input;
    hot loops stage once and call :func:`fused_propagate_tiled_staged`."""
    return basic_p.to(torch.float32).T.contiguous()


def fused_forward_plain(enc: EncodedStream, staged: torch.Tensor,
                        house: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: the op table walked in
    order, vectorised over trials (``(n_trials,)`` tops)."""
    return stream_forward_plain(enc, staged, house)[0]


def fused_forward(enc: EncodedStream, staged: torch.Tensor, house,
                  block_trials: int) -> torch.Tensor:
    """Top values ``(n_trials,)`` of staged ``(n_basic, n_trials)`` float32
    input.  CPU tensors run :func:`fused_forward_plain`; CUDA tensors
    launch ``csrc/fused.cu`` with ``block_trials`` trials per block (the
    tiled counterpart at 128, the lane-row one otherwise) or raise."""
    if staged.ndim != 2 or staged.shape[0] != enc.n_basic \
            or staged.dtype != torch.float32:
        raise LogicError(f"fused kernels take ({enc.n_basic}, n_trials) "
                         f"float32, got {tuple(staged.shape)} "
                         f"{staged.dtype}")
    if enc.top_slot < 0 or enc.pool_slots * block_trials * 4 > SMEM_BYTES:
        raise LogicError(f"{enc.pool_slots} gates x {block_trials} trials "
                         f"exceed one block's {SMEM_BYTES} B of shared "
                         f"memory (or the top is not a gate)")
    device = staged.device
    house_t = house_tensor(enc, house, device)
    if device.type != "cuda":
        return fused_forward_plain(enc, staged, house_t)
    from ._build import load_library
    lib = load_library()
    staged = staged.contiguous()
    _check_cuda(torch.float32, staged)
    T = staged.shape[1]
    ops, args, _fill = enc.tables(device)
    top = torch.empty(T, dtype=torch.float32, device=device)
    dp = _dp_scratch(enc, -(-T // block_trials), block_trials, staged)
    LAUNCHES["fused_tiled" if block_trials == TILED_TRIALS
             else "fused"] += 1
    code = lib.canopy_fused_forward_f32(
        ops.data_ptr(), args.data_ptr(), enc.n_ops, staged.data_ptr(),
        house_t.data_ptr(), top.data_ptr(), T, enc.pool_slots,
        enc.top_slot, block_trials, _ptr(dp),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "fused forward")
    return top


def fused_propagate(tree: CompiledTree, basic_p: torch.Tensor,
                    house_states) -> torch.Tensor:
    """Top-event values ``(n_trials,)`` float32 of ``(n_trials, n_basic)``
    probabilities, with the whole tree resident on chip (the lane-row
    counterpart, 32-trial blocks; check :func:`fused_supported` first)."""
    if not fused_supported(tree):
        raise ValueError(
            f"tree ({tree.n_gates} gates) exceeds the lane-row fused "
            f"kernel's shared memory ({SMEM_BYTES // (LANE_TRIALS * 4)} "
            f"gates); use the stream engine")
    return fused_forward(encode_fused(tree), tile_trials(basic_p),
                         house_states, LANE_TRIALS)


def fused_propagate_tiled(tree: CompiledTree, basic_p: torch.Tensor,
                          house_states) -> torch.Tensor:
    """:func:`fused_propagate` with 128-trial blocks (any trial count;
    check :func:`fused_tiled_supported` first)."""
    return fused_propagate_tiled_staged(tree, tile_trials(basic_p),
                                        house_states)


def fused_propagate_tiled_staged(tree: CompiledTree, p_tiled: torch.Tensor,
                                 house_states) -> torch.Tensor:
    """:func:`fused_propagate_tiled` on an input already staged by
    :func:`tile_trials`."""
    if not fused_tiled_supported(tree):
        raise ValueError(
            f"tree ({tree.n_gates} gates) exceeds the tiled fused "
            f"kernel's shared memory ({SMEM_BYTES // (TILED_TRIALS * 4)} "
            f"gates); use the lane-row kernel or the stream engine")
    return fused_forward(encode_fused(tree), p_tiled, house_states,
                         TILED_TRIALS)
