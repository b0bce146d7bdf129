"""Streaming schedule: register allocation for the windowed fused kernel.

The fused-tiled Pallas kernel (``ops/pallas_kernels.fused_propagate_tiled``)
runs the VPU at full width — every node holds an (8, 128) trial tile — but
requires the *whole tree* resident in VMEM, capping it at ~3k nodes.  This
module removes that cap by treating VMEM as a register file:

* Gates execute in **depth-first post-order** from the top event.  For
  tree-like graphs the live set at any point is O(depth x fan-in) — a few
  hundred tiles — regardless of total tree size (the level schedule, by
  contrast, keeps whole levels live).
* A **linear-scan allocator** assigns each value (gate output or staged
  basic) a slot in a fixed VMEM pool at definition and frees it after its
  last consumer, exactly like register allocation over a straight-line
  program.
* Basic-event tiles stream from HBM through a **ring of staging chunks**
  (default depth 3 — measured 0.92 of HBM on v5e, vs 0.82 double-
  buffered; the basics are laid out in first-use order, so each chunk
  is one contiguous DMA).  A basic whose last use would outlive its
  chunk's buffer (``n_bufs`` chunks ahead overwrites it) is
  **spilled**: copied from staging into a pool slot right after its
  chunk lands.

The result is a static op list — DMA starts/waits, spill copies, gate
evaluations on pool/staging slots — that the kernel unrolls verbatim.
Everything here is host-side numpy/python, exercised by interpret-mode
tests without a TPU.

Reference anchor: this is the quantification engine the reference
specifies but never built (``settings.h:13-22``, the absent
``src/bool/bool`` — SURVEY.md §2.6), scheduled for the TPU memory
hierarchy instead of a SYCL work queue.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import LogicError
from .graph import CompiledTree

__all__ = ["StreamProgram", "build_stream_schedule",
           "build_bdd_stream_schedule"]

#: VMEM working budget (bytes) for staging + pool tiles; leave headroom
#: under the ~16 MB/core for the pipeline's own buffers. 12 MiB pools
#: verified on v5e hardware (16k-gate uniform tree, pool 2565 tiles +
#: 2x128 staging: bit-exact, 0.139 ms/iter at T=4096).
_VMEM_BUDGET = 13 * 2 ** 20
_TILE_BYTES = 8 * 128 * 4

#: Unrolled-op safety cap: the kernel is a straight-line program, so
#: trace/compile time scales with edges.  Beyond this, use the gather
#: or block engines.
_MAX_EDGES = 400_000


@dataclasses.dataclass
class StreamProgram:
    """A straight-line streaming program over VMEM slots.

    ``ops`` entries (all indices are Python ints — static in-kernel):

    - ``("start", chunk, buf)`` — begin the async copy of staging chunk
      ``chunk`` into double buffer ``buf``.
    - ``("wait", chunk, buf)`` — wait for that copy.
    - ``("spill", buf, off, slot)`` — copy staging tile ``(buf, off)``
      into pool slot ``slot`` (long-lived basic).
    - ``("gate", kind, out_slot, args, aux)`` — evaluate one gate into
      pool slot ``out_slot``; ``args`` is a list of ``(loc, flag)`` where
      ``loc`` is ``("pool", slot)``, ``("stage", buf, off)`` or
      ``("house", house_pos)``; kind/aux as in the fused kernels
      (``prod``/``pair``/``count``).
    """

    ops: list
    basic_perm: np.ndarray    # (n_basic,) original basic slot at staging pos.
    n_basic: int
    n_basic_pad: int          # n_chunks * chunk_tiles.
    chunk_tiles: int
    n_chunks: int
    n_bufs: int               # Staging ring depth (op buf = chunk % n_bufs).
    pool_slots: int
    top_slot: int             # Pool slot holding the top value at the end.
    nnz: int
    n_house: int
    #: BDD programs: global value-vector columns backing the program's
    #: compact staged-input space (``basic_p = values[:, stage_cols]``).
    stage_cols: np.ndarray | None = None

    @property
    def vmem_bytes(self) -> int:
        bufs = min(self.n_chunks, self.n_bufs)
        return (bufs * self.chunk_tiles + self.pool_slots) * _TILE_BYTES


def _emit_gate_ops(tree: CompiledTree):
    """Per-gate (kind, out_slot, args, aux) rows from the level blocks.

    Same flattening as the fused kernels; args keep formula order so the
    floating-point reduction order (hence the result) is bit-identical
    to the gather engine.
    """
    ops = []
    for level in tree.levels:
        for kind, b in level.iter_blocks():
            if kind == "prod":
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_flip[g, f]))
                            for f in range(b.arg_idx.shape[1])
                            if b.arg_mask[g, f]]
                    ops.append(("prod", int(b.out_idx[g]), args,
                                bool(b.inv_out[g])))
            elif kind == "pair":
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_neg[g, f]))
                            for f in range(2)]
                    ops.append(("pair", int(b.out_idx[g]), args,
                                bool(b.is_iff[g])))
            else:
                for g in range(b.n_gates):
                    args = [(int(b.arg_idx[g, f]), bool(b.arg_neg[g, f]))
                            for f in range(b.arg_idx.shape[1])
                            if b.arg_mask[g, f]]
                    ops.append(("count", int(b.out_idx[g]), args,
                                (int(b.min_num[g]), int(b.max_num[g]))))
    return ops


def build_stream_schedule(tree: CompiledTree, chunk_tiles: int = 256,
                          n_bufs: int = 3) -> StreamProgram:
    """Compile ``tree`` into a :class:`StreamProgram`.

    Raises :class:`LogicError` when the tree needs more pool slots than
    the VMEM budget allows (pathologically wide live sets) or exceeds
    the unrolled-op cap — callers fall back to another engine.
    """
    if tree.top_index is None:
        raise LogicError("stream schedule needs an anchored top event")
    return _build_schedule(_emit_gate_ops(tree), tree.n_basic,
                           tree.n_house, tree.top_index, chunk_tiles,
                           n_bufs)


def build_bdd_stream_schedule(bdd, chunk_tiles: int = 256,
                              n_bufs: int = 3) -> StreamProgram:
    """Schedule an exact ROBDD evaluation as a streaming program.

    Every BDD node is one fused ``mux`` op — ``p*hi + (1-p)*lo``, the
    Shannon recursion of ``engine/bdd_eval.bdd_probability`` — reading
    the decision variable's staged basic tile and the children's pool
    tiles; terminals become constant fills.  The result evaluates exact
    per-trial top probabilities (shared events included) at the
    streaming kernel's rate.
    """
    if bdd.raw_var is None:
        raise LogicError("CompiledBdd is missing raw node arrays")
    root = bdd.resolved_root()
    if root <= 1:
        raise LogicError("constant BDD: nothing to stream")
    var_arr, low_arr, high_arr = bdd.raw_var, bdd.raw_low, bdd.raw_high
    slot_of_var = bdd.slot_of_var
    # Children precede parents by index in the forest arrays.
    reach: set[int] = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if n <= 1 or n in reach:
            continue
        reach.add(n)
        stack.append(int(low_arr[n]))
        stack.append(int(high_arr[n]))
    # Compact staged-input space: only the decision variables this BDD
    # actually reads (module BDDs read a few globals out of thousands).
    used_vars = sorted({int(var_arr[n]) for n in reach})
    local_of_var = {v: i for i, v in enumerate(used_vars)}
    stage_cols = np.array([slot_of_var[v] for v in used_vars],
                          dtype=np.int64)
    n_b = len(used_vars)
    rows = [("fill", n_b + 0, [], 0.0), ("fill", n_b + 1, [], 1.0)]
    for n in sorted(reach):
        rows.append(("mux", n_b + n, [
            (local_of_var[int(var_arr[n])], False),
            (n_b + int(high_arr[n]), False),
            (n_b + int(low_arr[n]), False)], None))
    program = _build_schedule(rows, n_b, 0, n_b + root, chunk_tiles,
                              n_bufs)
    program.stage_cols = stage_cols
    return program


def _dfs_exec_rows(gate_rows, n_b: int, n_h: int, top_index: int) -> list:
    """Depth-first post-order of the top cone (iterative), visiting each
    gate once — the execution order shared by the stream and spill
    schedulers (basics get their first-use rank along the way)."""
    op_of_slot = {row[1]: row for row in gate_rows}
    exec_rows = []
    seen: set[int] = set()
    stack: list[tuple[int, bool]] = [(top_index, False)]
    while stack:
        slot, expanded = stack.pop()
        if expanded:
            exec_rows.append(op_of_slot[slot])
            continue
        if slot in seen:
            continue
        seen.add(slot)
        stack.append((slot, True))
        row = op_of_slot[slot]
        for arg_slot, _flag in reversed(row[2]):
            if arg_slot >= n_b + n_h and arg_slot not in seen:
                stack.append((arg_slot, False))
    return exec_rows


def _build_schedule(gate_rows, n_basic: int, n_house: int, top_index: int,
                    chunk_tiles: int, n_bufs: int = 3) -> StreamProgram:
    if n_basic == 0:
        raise LogicError("stream schedule needs at least one basic event")

    n_b = n_basic
    n_h = n_house
    exec_rows = _dfs_exec_rows(gate_rows, n_b, n_h, top_index)
    n_ops = len(exec_rows)
    exec_nnz = sum(len(row[2]) for row in exec_rows)
    if exec_nnz > _MAX_EDGES:
        raise LogicError(
            f"top-event cone has {exec_nnz} edges; beyond the "
            f"unrolled-kernel cap ({_MAX_EDGES}) — use the gather engine")

    # Basic staging order = first use in the execution sequence.
    first_use: dict[int, int] = {}
    last_use: dict[int, int] = {}
    for g, row in enumerate(exec_rows):
        for arg_slot, _flag in row[2]:
            if arg_slot < n_b:
                first_use.setdefault(arg_slot, g)
                last_use[arg_slot] = g
    basic_perm = np.fromiter(
        sorted(first_use, key=first_use.__getitem__), dtype=np.int64,
        count=len(first_use))
    # Basics unreachable from the top (shouldn't happen for compiled
    # trees, but harmless) go to the tail — never staged-read.
    if len(basic_perm) < n_b:
        rest = np.setdiff1d(np.arange(n_b), basic_perm)
        basic_perm = np.concatenate([basic_perm, rest])

    n_chunks = -(-n_b // chunk_tiles)
    n_basic_pad = n_chunks * chunk_tiles
    stage_pos = {int(slot): pos for pos, slot in enumerate(basic_perm)}
    chunk_of = {s: stage_pos[s] // chunk_tiles for s in stage_pos}

    # Staging order puts used basics first, so used chunks are a prefix;
    # chunks with no used basics are never staged (an un-consumed DMA
    # would leave its semaphore pending or overwrite a live buffer).
    n_active = -(-len(first_use) // chunk_tiles) if first_use else 0

    # First gate-op needing each chunk (nondecreasing by construction).
    chunk_first_use = [n_ops] * n_chunks
    for s, g in first_use.items():
        c = chunk_of[s]
        chunk_first_use[c] = min(chunk_first_use[c], g)

    # Spill rule: with an n_bufs-deep staging ring, chunk c's tiles die
    # when chunk c+n_bufs starts loading; any basic read at or past that
    # chunk's first use must move to the pool.
    spilled: set[int] = set()
    for s, g_last in last_use.items():
        c = chunk_of[s]
        if c + n_bufs < n_active \
                and g_last >= chunk_first_use[c + n_bufs]:
            spilled.add(s)

    # DMA start placement: chunk c may start once every staging read of
    # chunk c-n_bufs is done — non-spilled last uses plus the spill
    # copies (which land right after that chunk's wait).
    chunk_last_stage_read = [0] * n_chunks
    for c in range(n_active):
        chunk_last_stage_read[c] = \
            chunk_first_use[c] if chunk_first_use[c] < n_ops else 0
    for s, g_last in last_use.items():
        if s not in spilled:
            c = chunk_of[s]
            if g_last > chunk_last_stage_read[c]:
                chunk_last_stage_read[c] = g_last

    # Events attached before each gate op (priority: starts, waits,
    # spills, then the gate itself).
    starts_before: list[list[int]] = [[] for _ in range(n_ops + 1)]
    waits_before: list[list[int]] = [[] for _ in range(n_ops + 1)]
    for c in range(n_active):
        at = 0 if c < n_bufs else \
            min(chunk_last_stage_read[c - n_bufs] + 1, n_ops)
        w = chunk_first_use[c] if chunk_first_use[c] < n_ops else n_ops
        if at > w:
            # A single gate's arguments span more staging chunks than
            # the ring holds (its buffer would have to load while still
            # being read): no valid schedule exists at this depth.
            raise LogicError(
                f"stream schedule: chunk {c} must start after op {at} "
                f"but is needed at op {w} (gate fan-in spans over "
                f"{n_bufs} chunks of {chunk_tiles} tiles) — use the "
                "gather engine")
        starts_before[at].append(c)
        waits_before[w].append(c)

    # Linear-scan pool allocation over gates + spilled basics.
    free: list[int] = []
    n_slots = 0
    slot_of: dict[int, int] = {}          # value slot -> pool slot

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    # Last gate-op reading each *gate* output (for frees).
    gate_last_use: dict[int, int] = {}
    for g, row in enumerate(exec_rows):
        for arg_slot, _flag in row[2]:
            if arg_slot >= n_b + n_h:
                gate_last_use[arg_slot] = g

    # Spilled basics grouped by the chunk whose wait precedes their copy.
    spills_of_chunk: dict[int, list[int]] = {}
    for s in spilled:
        spills_of_chunk.setdefault(chunk_of[s], []).append(s)

    ops: list = []
    frees_at: dict[int, list[int]] = {}   # gate index -> value slots to free

    def emit_chunk_events(c: int):
        buf = c % n_bufs
        ops.append(("wait", c, buf))
        for s in sorted(spills_of_chunk.get(c, ()),
                        key=stage_pos.__getitem__):
            slot = alloc()
            slot_of[s] = slot
            ops.append(("spill", buf, stage_pos[s] % chunk_tiles, slot))
            frees_at.setdefault(last_use[s], []).append(s)

    for g in range(n_ops + 1):
        for c in sorted(starts_before[g]):
            ops.append(("start", c, c % n_bufs))
        for c in sorted(waits_before[g]):
            emit_chunk_events(c)
        if g == n_ops:
            break
        kind, out_slot, args, aux = exec_rows[g]
        locs = []
        for arg_slot, flag in args:
            if arg_slot < n_b:
                if arg_slot in spilled:
                    locs.append((("pool", slot_of[arg_slot]), flag))
                else:
                    pos = stage_pos[arg_slot]
                    locs.append((("stage",
                                  (pos // chunk_tiles) % n_bufs,
                                  pos % chunk_tiles), flag))
            elif arg_slot < n_b + n_h:
                locs.append((("house", arg_slot - n_b), flag))
            else:
                locs.append((("pool", slot_of[arg_slot]), flag))
        out_pool = alloc()
        slot_of[out_slot] = out_pool
        ops.append(("gate", kind, out_pool, locs, aux))
        if out_slot != top_index:
            if out_slot in gate_last_use:
                frees_at.setdefault(gate_last_use[out_slot], []) \
                    .append(out_slot)
            else:  # Never consumed (multi-root leftovers): free now.
                free.append(out_pool)
        for v in frees_at.pop(g, ()):
            free.append(slot_of[v])

    bufs = min(n_active, n_bufs)
    vmem = (bufs * chunk_tiles + n_slots) * _TILE_BYTES
    if vmem > _VMEM_BUDGET:
        raise LogicError(
            f"stream schedule needs {n_slots} pool slots + "
            f"{bufs}x{chunk_tiles} staging tiles = {vmem} bytes VMEM "
            f"(budget {_VMEM_BUDGET}); live set too wide for streaming")

    return StreamProgram(
        ops=ops, basic_perm=basic_perm, n_basic=n_b,
        n_basic_pad=n_basic_pad, chunk_tiles=chunk_tiles,
        n_chunks=n_active, n_bufs=n_bufs, pool_slots=n_slots,
        top_slot=slot_of[top_index], nnz=exec_nnz, n_house=n_h)
