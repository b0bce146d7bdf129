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
path for shared-event models.

:func:`make_propagator` picks an engine for a tree once and returns the
evaluator: on CUDA the uncapped tree stream's hand-written kernel (the
fused whole-tree, replay, spill and block-gather kernels on request),
elsewhere this gather engine.
:func:`make_staged_propagator` splits the stream engine's staging from
its kernel for hot loops.  ``make_param_propagator`` is not ported: it
existed to keep index arrays out of remote-compile requests, and torch
takes index tensors as plain arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..compiler.graph import CompiledTree, CountBlock, PairBlock, ProdBlock
from ..utils.profiling import to_device

__all__ = ["propagate_probability", "top_event_probability",
           "propagate_node_major", "make_propagator",
           "make_staged_propagator", "mean_basic_probabilities",
           "spill_auto_ok"]


def _compute_dtype(vals: torch.Tensor) -> torch.dtype:
    """Gate math runs in >= f32 even when the value matrix is stored
    narrow; one rounding per level instead of one per multiply."""
    return torch.promote_types(vals.dtype, torch.float32)


def _t(array, device) -> torch.Tensor:
    return to_device(np.ascontiguousarray(array), device)


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


#: The JAX package's thrashing guard for the spill tier under its TPU auto
#: dispatch: a schedule refilling more than this share of its ops trails
#: gather there.  Kept as the same logic; the port's auto dispatch never
#: picks spill (the uncapped stream runs every anchored tree,
#: ``_auto_engine``).
_SPILL_MAX_REFILL_DENSITY = 0.15


def spill_auto_ok(spill_program) -> bool:
    """Whether the JAX package's auto dispatch would use this spill
    schedule (callers may still force it with ``engine="spill"``)."""
    return (spill_program.n_refills
            <= _SPILL_MAX_REFILL_DENSITY * spill_program.n_ops)


def _build_house(tree: CompiledTree,
                 house_states: np.ndarray | None) -> np.ndarray:
    if house_states is None:
        return tree.house_state_vector()
    return np.asarray(house_states, dtype=np.float64)


def _auto_engine(tree: CompiledTree, device: torch.device,
                 output: str) -> str:
    """The engine ``engine="auto"`` runs: on CUDA with an anchored top the
    uncapped tree stream, which serves every tree (the fused kernel
    measured faster than it on two trees and slower on a third, each
    within about a tenth, ``PERF.md``; no benchmark cell has chosen
    between them yet); gather on the CPU, for ``output="all"`` and for a
    tree without an anchored top."""
    if device.type != "cuda" or output != "top" or tree.top_index is None:
        return "gather"
    return "stream"


def _named(fn, engine: str, variant: str | None = None):
    """Tag ``fn`` with the engine that runs; a stream engine also carries
    ``stream_variant``, the forward kernel it launches
    (``ops/stream_kernel.stream_variant``)."""
    fn.engine = engine
    if variant is not None:
        fn.stream_variant = variant
    return fn


def make_propagator(tree: CompiledTree, device, output: str = "top",
                    engine: str = "auto",
                    house_states: np.ndarray | None = None):
    """An evaluator ``f(basic_p, house_states=None) -> prob`` for
    ``(..., n_basic)`` probabilities on ``device``; ``f.engine`` names the
    engine that runs.

    ``house_states`` fixes the house-event vector at build time (default:
    the tree's current states).  The kernel engines bake it into their
    program as float32 constants, and a per-call override raises
    ``ValueError``; only the gather engine honours one.

    ``output``: ``"top"`` for the top event's value, ``"all"`` for every
    node's (gather only).  ``engine``:

    * ``"gather"`` — this module's level evaluation in the input's dtype
      (top-only queries evaluate the pruned top cone, bit-identical);
    * ``"fused"`` — the whole-tree kernel (``ops/fused_kernel.py``), the
      tiled counterpart when the tree fits it, else the lane-row one;
      float32, ``(n_trials, n_basic)`` input;
    * ``"stream"`` — the stream kernel on the tree's uncapped stream
      program (``ops/stream_kernel.compile_tree_stream``); float32,
      ``(n_trials, n_basic)`` input;
    * ``"replay"`` — the replay kernel on the tree's replay program
      (``ops/stream_kernel.compile_replay_stream``: a shared-memory pool,
      an eviction log in device memory); float32,
      ``(n_trials, n_basic)`` input;
    * ``"spill"`` — the spill kernel on the tree's Belady spill program
      (``ops/stream_kernel.compile_spill_stream``: a shared-memory pool,
      evictions to scratch rows in device memory, single refills);
      float32, ``(n_trials, n_basic)`` input;
    * ``"block"`` — the block-gather log kernel on the tree's
      block-gather program (``ops/block_gather.compile_block_gather``,
      built here: it raises ``LogicError`` for a tree with pair or count
      gates, house events, or argument spans over ``r_max`` rows, as an
      unreordered big tree has; run ``compiler/reorder.locality_reorder``
      with ``hot_first=True`` first); float32, ``(n_trials, n_basic)``
      input with ``n_trials % 128 == 0``;
    * ``"auto"`` — on CUDA the stream kernel; the gather engine on the
      CPU, for ``output="all"`` or without an anchored top.  No CUDA path
      falls back to gather, and auto never picks the fused, replay, spill
      or block kernels (explicit engines, as in the JAX package).

    On the CPU ``"fused"``, ``"stream"``, ``"replay"``, ``"spill"`` and
    ``"block"`` run the kernels' plain versions (the rehearsal the tests
    use).
    """
    from ..ops.block_gather import (block_gather_propagate,
                                    compile_block_gather)
    from ..ops.fused_kernel import (fused_propagate, fused_propagate_tiled,
                                    fused_supported, fused_tiled_supported)
    from ..ops.stream_kernel import (compile_replay_stream,
                                     compile_spill_stream, encode_replay,
                                     encode_spill, replay_propagate,
                                     spill_propagate, stream_propagate,
                                     stream_variant, tree_stream_encoding)
    device = torch.device(device)
    if engine not in ("auto", "gather", "fused", "stream", "replay",
                      "spill", "block"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto":
        engine = _auto_engine(tree, device, output)
    elif engine == "fused":
        engine = "fused_tiled" if fused_tiled_supported(tree) else "fused"
    house = _build_house(tree, house_states)

    if engine != "gather":
        if output != "top":
            raise ValueError(f"the {engine} engine only produces the top "
                             f"value")
        variant = None
        if engine == "stream":
            enc = tree_stream_encoding(tree)
            variant = stream_variant(enc)

            def run(basic_p):
                return stream_propagate(enc, basic_p, house)
        elif engine == "replay":
            renc = encode_replay(compile_replay_stream(tree))

            def run(basic_p):
                return replay_propagate(renc, basic_p, house)
        elif engine == "spill":
            senc = encode_spill(compile_spill_stream(tree))

            def run(basic_p):
                return spill_propagate(senc, basic_p, house)
        elif engine == "block":
            program = compile_block_gather(tree)

            def run(basic_p):
                return block_gather_propagate(program, basic_p)
        elif engine == "fused_tiled":
            def run(basic_p):
                return fused_propagate_tiled(tree, basic_p, house)
        elif fused_supported(tree):
            def run(basic_p):
                return fused_propagate(tree, basic_p, house)
        else:
            raise ValueError(f"tree ({tree.n_gates} gates) does not fit the "
                             f"fused kernels; use the stream engine")

        def fn(basic_p, house_states=None):
            if house_states is not None:
                raise ValueError(
                    f"the {engine} engine bakes house states at build "
                    f"time; pass them to make_propagator(house_states=...)")
            return run(basic_p)
        return _named(fn, engine, variant)

    baked = torch.as_tensor(house, device=device)
    if output == "top":
        # Top-only queries skip gates outside the top cone (bit-identical:
        # per-gate argument lists are unchanged).
        eval_tree = tree
        if tree.top_index is not None:
            from ..compiler.graph import prune_to_top_cone
            eval_tree = prune_to_top_cone(tree)

        def fn(basic_p, house_states=None):
            h = baked if house_states is None else house_states
            return top_event_probability(eval_tree, basic_p, h)
    else:
        def fn(basic_p, house_states=None):
            h = baked if house_states is None else house_states
            return propagate_probability(tree, basic_p, h)
    return _named(fn, "gather")


def make_staged_propagator(tree: CompiledTree, device,
                           house_states: np.ndarray | None = None,
                           engine: str = "auto"):
    """An amortizing ``(stage, run)`` pair for hot loops.

    ``staged = stage(basic_p)`` pays the input layout transform once;
    ``run(staged)`` then runs the kernel per call.  As in the JAX
    package: the stream engine (here the uncapped tree stream, so it
    exists for every anchored tree) on CUDA, otherwise the identity stage
    over the gather engine on the pruned top cone.  ``engine="stream"``
    forces the stream pair on the CPU (the kernels' plain versions);
    ``engine="replay"`` gives ``(stage_replay, replay_propagate_staged)``
    on the tree's replay program, on any device.  Callers hold the staged
    tensor themselves: there is no cache keyed on the input's identity.
    ``run.engine`` names the engine.
    """
    from ..ops.stream_kernel import (compile_replay_stream, encode_replay,
                                     replay_propagate_staged, stage_basic,
                                     stage_replay, stream_propagate_staged,
                                     stream_variant, tree_stream_encoding)
    device = torch.device(device)
    house = _build_house(tree, house_states)
    if engine == "replay":
        renc = encode_replay(compile_replay_stream(tree))

        def stage_r(basic_p):
            return stage_replay(renc, basic_p)

        def run_r(staged):
            return replay_propagate_staged(renc, staged, house)
        return stage_r, _named(run_r, "replay")
    streams = engine == "stream" or (engine == "auto"
                                     and device.type == "cuda")
    if streams and tree.top_index is not None:
        enc = tree_stream_encoding(tree)

        def stage(basic_p):
            return stage_basic(enc, basic_p)

        def run(staged):
            return stream_propagate_staged(enc, staged, house)
        return stage, _named(run, "stream", stream_variant(enc))
    gather = make_propagator(tree, device, "top", "gather", house)

    def run_gather(basic_p):
        return gather(basic_p)
    return (lambda p: p), _named(run_gather, "gather")


def mean_basic_probabilities(tree: CompiledTree) -> np.ndarray:
    """Host-side mean probability vector from the MEF expressions."""
    return np.array([event.p() for event in tree.basic_events],
                    dtype=np.float64)
