"""Fused whole-tree propagation: CUDA kernel and plain version.

The counterpart of the fused half of ``canopy_tpu/ops/pallas_kernels.py``:
``fused_propagate_tiled`` / ``fused_propagate_tiled_staged`` (the
``_make_tiled_kernel`` body, 1024-trial (8, 128) tiles per node) and
``fused_propagate`` (its lane-row kernel, 128-trial rows).  Both compute
the top event's value per trial, in float32, with the whole tree in one
launch: gates in ``_emit_gate_ops`` order (level order; prod, pair and
count ops), house states baked in as float32 constants.

On the H100 both are one hand-written kernel, ``csrc/fused.cu``: the ring
body of ``csrc/replay_ops.cuh`` on the tree's live-row program
(:func:`fused_program`: the same ops in the same order, each gate writing
a row freed by a gate whose last reader has read it), its rows in device
memory, the op stream in TMA-loaded shared-memory chunks and every
basic-event read through a per-thread cp.async prefetch ring
(:func:`fused_plan` gives the launch shape).  The two entry
points run the same kernel; they differ in the TPU counterpart they
stand for, which the JAX package chose by the gates its VMEM holds at a
row width, and which ``make_propagator(engine="fused")`` names by the
same rule on a block's shared memory (232,448 bytes on an H100):

============  =================  ==================
Variant       Trials per row     Most gates
============  =================  ==================
tiled         128                454
lane-row      32                 1,816
============  =================  ==================

The TPU's ``n_trials % 1024`` rule has no counterpart: any trial count
works.

Layout.  The staged input is ``(n_basic, n_trials)`` float32 in the
tree's basic order, trials contiguous (:func:`tile_trials`), so a warp's
read of one basic is one coalesced segment; the JAX package's
``(n_tiles, n_basic, 8, 128)`` tiling has no meaning here.

Dispatch.  A wrapper runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor (or raises); ``COUNTERS["launch.fused_tiled"]``
and ``COUNTERS["launch.fused"]`` count launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..compiler.schedule import _emit_gate_ops
from ..errors import LogicError
from ..utils.profiling import COUNTERS
from ._build import _ptr, _raise_on, load_library
from .stream_kernel import (HOUSE, POOL, SMEM_BYTES, STAGED,
                            EncodedSpill, EncodedStream,
                            ReplayPlan, _KIND, _chunk_words, _check_cuda,
                            _count_row, _dp_scratch,
                            house_tensor, replay_ring_stream,
                            stream_forward_plain)

__all__ = ["SMEM_BYTES", "TILED_TRIALS", "LANE_TRIALS", "fused_supported",
           "fused_tiled_supported", "encode_fused", "fused_program",
           "fused_plan", "tile_trials", "fused_forward",
           "fused_forward_plain", "fused_propagate", "fused_propagate_tiled",
           "fused_propagate_tiled_staged"]

#: Trials per row of the TPU's tiled counterpart and of its lane-row one,
#: as sized on the card (:func:`fused_tiled_supported`,
#: :func:`fused_supported`).
TILED_TRIALS = 128
LANE_TRIALS = 32
#: Trials per block and ring depth of the fused kernel (``csrc/fused.cu``
#: FUSED_THREADS, FUSED_DEPTH): 128-trial blocks, whose registers are
#: capped for 16 blocks per SM, and 7 staged reads in flight per thread;
#: the fastest of the shapes measured on the card (``PERF.md``).
FUSED_BLOCK_TRIALS = 128
FUSED_RING_DEPTH = 8


def _fits(tree: CompiledTree, block_trials: int) -> bool:
    return tree.top_index is not None and tree.n_gates > 0 and \
        tree.top_index >= tree.n_basic + tree.n_house and \
        tree.n_gates * block_trials * 4 <= SMEM_BYTES


def fused_supported(tree: CompiledTree) -> bool:
    """True when the tree is a lane-row tree: the top is a gate and its
    gates at 32-trial rows fit one block's shared memory (at most 1,816),
    as the JAX lane-row kernel's predicate sizes VMEM."""
    return _fits(tree, LANE_TRIALS)


def fused_tiled_supported(tree: CompiledTree) -> bool:
    """True when the tree is a tiled tree: 128-trial rows, at most 454
    gates."""
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
    top = tree.top_index - base if tree.top_index is not None else -1
    enc = EncodedStream(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.zeros(len(ops), dtype=np.float32), n_log=0, n_basic=n_b,
        n_house=tree.n_house, pool_slots=max(tree.n_gates, 1),
        top_slot=top, max_count_states=max_states,
        staged_cols=np.arange(n_b, dtype=np.int64),
        out_slots=np.asarray([top], dtype=np.int32))
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


def fused_program(enc: EncodedStream) -> EncodedSpill:
    """:func:`encode_fused`'s table with its gate rows reassigned by
    liveness, in the same op order (cached on ``enc``).

    A row is free again once the last gate that reads its value has read
    it, so a gate may write the row one of its own arguments frees (the
    kernel reads every argument before it stores); a gate no gate reads
    frees its row at once; the top's row is never freed.  A gate takes
    the row freed last, else a new one, so the rows are the peak live
    set.  Arguments, arithmetic and order are unchanged, so the top is
    bit-equal to the table's.  The program is an eviction-free spill
    program (``stream_kernel.replay_ring_stream`` encodes it).
    """
    live = enc._cache.get("live")
    if live is not None:
        return live
    ops, args = enc.ops.copy(), enc.args.copy()
    last: dict[int, int] = {}
    for o, (b, e) in enumerate(enc.ops[:, 2:4].tolist()):
        for src, gate in enc.args[b:e, :2].tolist():
            if src == POOL:
                last[gate] = o
    row_of: dict[int, int] = {}
    free: list = []
    n_rows = 0
    for o, (kind, gate, b, e, *_rest) in enumerate(enc.ops.tolist()):
        read = []
        for j in range(b, e):
            if args[j, 0] == POOL:
                old = int(enc.args[j, 1])
                args[j, 1] = args[j, 4] = row_of[old]
                if old not in read:
                    read.append(old)
        free += [row_of[g] for g in read
                 if last[g] == o and g != enc.top_slot]
        if free:
            row = free.pop()
        else:
            row, n_rows = n_rows, n_rows + 1
        row_of[gate] = ops[o, 1] = row
        if gate not in last and gate != enc.top_slot:
            free.append(row)
    top = row_of.get(enc.top_slot, -1)
    live = EncodedSpill(
        ops=ops, args=args, fill=enc.fill, n_log=enc.n_log,
        n_basic=enc.n_basic, n_house=enc.n_house, pool_slots=max(n_rows, 1),
        top_slot=top, max_count_states=enc.max_count_states,
        staged_cols=enc.staged_cols,
        out_slots=np.asarray([top], dtype=np.int32),
        n_scratch=0, counts=dict(spills=0, evictions=0, staged_refills=0,
                                 scratch_refills=0, segments=1))
    enc._cache["live"] = live
    return live


def fused_plan(enc: EncodedStream) -> tuple[EncodedSpill, ReplayPlan]:
    """The kernel's program and launch shape: :func:`fused_program`, in
    blocks of ``FUSED_BLOCK_TRIALS`` trials with a ring of
    ``FUSED_RING_DEPTH`` rows.  The rows live in device memory, one
    column per trial (``live.pool_slots`` rows: the program's peak live
    set), so no tree is too large; a block's shared memory holds the two
    op-stream chunks, sized by the program's longest op
    (``stream_kernel._chunk_words``), and the ring."""
    live = fused_program(enc)
    width, depth = FUSED_BLOCK_TRIALS, FUSED_RING_DEPTH
    chunk = _chunk_words(live)
    return live, ReplayPlan(width, depth, chunk,
                            16 + 8 * chunk + depth * width * 4)


def fused_forward(enc: EncodedStream, staged: torch.Tensor, house,
                  tiled: bool = False) -> torch.Tensor:
    """Top values ``(n_trials,)`` of staged ``(n_basic, n_trials)`` float32
    input.  CPU tensors run :func:`fused_forward_plain`; CUDA tensors
    launch ``csrc/fused.cu`` on :func:`fused_plan`, counted as the tiled
    counterpart (``tiled``) or the lane-row one, or raise."""
    if staged.ndim != 2 or staged.shape[0] != enc.n_basic \
            or staged.dtype != torch.float32:
        raise LogicError(f"fused kernels take ({enc.n_basic}, n_trials) "
                         f"float32, got {tuple(staged.shape)} "
                         f"{staged.dtype}")
    if enc.top_slot < 0:
        raise LogicError("the fused kernels need a gate as the top")
    device = staged.device
    house_t = house_tensor(enc, house, device)
    if device.type != "cuda":
        return fused_forward_plain(enc, staged, house_t)
    live, plan = fused_plan(enc)
    lib = load_library()
    staged = staged.contiguous()
    _check_cuda(torch.float32, staged)
    T = staged.shape[1]
    ring = replay_ring_stream(live, plan.depth)
    words, head = ring.tables(device)
    blocks = -(-T // plan.width)
    rows = torch.empty((live.pool_slots, blocks * plan.width),
                       dtype=torch.float32, device=device)
    top = torch.empty(T, dtype=torch.float32, device=device)
    dp = _dp_scratch(live, blocks, plan.width, staged)
    COUNTERS["launch.fused_tiled" if tiled else "launch.fused"] += 1
    code = lib.canopy_fused_forward_f32(
        words.data_ptr(), ring.n_chunks, ring.chunk_words, head.data_ptr(),
        staged.data_ptr(), house_t.data_ptr(), rows.data_ptr(),
        top.data_ptr(), T, live.pool_slots, live.top_slot, plan.width,
        plan.depth, _ptr(dp), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "fused forward")
    return top


def fused_propagate(tree: CompiledTree, basic_p: torch.Tensor,
                    house_states) -> torch.Tensor:
    """Top-event values ``(n_trials,)`` float32 of ``(n_trials, n_basic)``
    probabilities, the whole tree in one launch (the lane-row
    counterpart; check :func:`fused_supported` first)."""
    if not fused_supported(tree):
        raise ValueError(
            f"tree ({tree.n_gates} gates) exceeds the lane-row fused "
            f"counterpart ({SMEM_BYTES // (LANE_TRIALS * 4)} gates); use "
            f"the stream engine")
    return fused_forward(encode_fused(tree), tile_trials(basic_p),
                         house_states)


def fused_propagate_tiled(tree: CompiledTree, basic_p: torch.Tensor,
                          house_states) -> torch.Tensor:
    """:func:`fused_propagate` as the tiled counterpart (any trial count;
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
            f"counterpart ({SMEM_BYTES // (TILED_TRIALS * 4)} gates); use "
            f"the lane-row kernel or the stream engine")
    return fused_forward(encode_fused(tree), p_tiled, house_states,
                         tiled=True)
