"""Stream programs on PyTorch: encoder, CUDA forward kernel, plain version.

A :class:`~canopy_tpu_torch.compiler.schedule.StreamProgram` (gates in
depth-first order over a linear-scan-allocated pool: the scheduler shared
with the JAX package, or :func:`compile_tree_stream` and
:func:`compile_bdd_stream`, the same order without the TPU's caps) is
encoded once on the host into int32/float32 tables
(:func:`encode_stream`) and then run either by the hand-written
CUDA kernel ``csrc/stream.cu`` or by :func:`stream_forward_plain`, the
plain PyTorch version of the same arithmetic in the same op order.

Replaces ``canopy_tpu/ops/stream_kernel.py:_stream_kernel`` (and, with the
value log, ``canopy_tpu/ops/adjoint_kernel.py:_tape_kernel``).  The TPU
kernel streamed (8, 128) trial tiles through VMEM with staging-chunk DMAs.
On the H100 (``csrc/stream.cu``) the forward runs trial-parallel, the
pool in device memory: programs of muxes (BDD programs) run the step
kernel, ops as packed records (:func:`pack_records`) in steps of
independent muxes, two float32 trials per thread; other programs the
one-trial-per-thread kernel (:func:`stream_variant` picks;
``make_propagator``'s ``stream_variant`` attribute names it).  With the
value log (importance) it runs level-parallel instead: the ops of each
level of :func:`level_schedule` in parallel within a trial.  Any trial
count works.

Layouts.  The staged input is ``(n_basic, n_trials)`` in the program's
staging order (row = staging position), the transpose of the JAX
package's tile-major ``(n_tiles * n_basic_pad, 8, 128)``: the TPU tiling
and chunk padding have no meaning here.  Its dtype, float32 or float64,
is the kernels' value type (uncertainty batches run f32, importance
f64).  Every public function
takes and returns ``(n_trials, ...)`` like the JAX package's.

Replay programs.  The JAX package keeps its replay engine here too
(``_replay_kernel``, ``replay_propagate_staged``), and so does the port:
:func:`compile_replay_stream` sizes ``compiler/replay.py``'s schedule for
shared memory, :func:`encode_replay` flattens it into one op table of the
same format, and :func:`replay_forward` runs it through ``csrc/replay.cu``
(:func:`replay_ring_stream`, the table as the ring kernel's op stream, in
:func:`replay_plan`'s block width and ring depth) or
:func:`replay_forward_plain`.  The staged basic replay stream is
``(brs_len_pad, n_trials)``, one row per basic read, trials contiguous.

Spill programs.  :func:`compile_spill_stream` sizes
``compiler/spill.py``'s Belady schedule for shared memory,
:func:`encode_spill` flattens it into the same op-table format, and
:func:`spill_forward` runs it through ``csrc/spill.cu`` (the replay
forward's ring kernel: :func:`replay_ring_stream` and :func:`replay_plan`
take a spill program too) or :func:`spill_forward_plain`.  Their staged
input is ``(n_basic, n_trials)`` in the program's staging order, as for
stream programs.

Dispatch.  A wrapper runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; it never catches a build or launch failure and
never moves data between devices.  ``COUNTERS["launch.<kernel>"]``
(``utils/profiling.py``) counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..compiler.schedule import StreamProgram, build_stream_schedule
from ..errors import LogicError
from ..utils.profiling import COUNTERS, to_device
from ._build import _ptr, _raise_on, load_library

__all__ = ["compile_stream", "compile_bdd_stream", "compile_tree_stream",
           "tree_stream_encoding", "bdd_stream_encoding", "BDD_BATCH",
           "EncodedStream", "UncappedProgram",
           "encode_stream", "stage_basic", "unstage_basic",
           "stream_forward", "stream_forward_plain", "stream_roots_forward",
           "stream_roots_forward_plain", "stream_propagate",
           "stream_propagate_staged", "stream_bdd_probability", "house_tensor",
           "SMEM_BYTES", "REPLAY_SLOTS", "SPILL_SLOTS", "REPLAY_TRIALS",
           "SPILL_TRIALS",
           "REPLAY_RING_DEPTHS", "REPLAY_RING_BYTES", "REPLAY_CHUNK_WORDS",
           "ReplayPlan", "replay_plan", "RingStream", "replay_ring_stream",
           "compile_replay_stream", "EncodedReplay", "encode_replay",
           "stage_replay", "unstage_replay", "replay_grad_basic",
           "replay_forward", "replay_forward_plain", "replay_propagate",
           "replay_propagate_staged", "compile_spill_stream", "EncodedSpill",
           "encode_spill", "spill_forward", "spill_forward_plain",
           "spill_propagate", "spill_propagate_staged", "count_window",
           "REC_CHUNK", "pack_records", "stream_variant", "LevelSchedule",
           "level_schedule", "schedule_levels", "level_tile",
           "stream_forward_levels_plain"]

# Op kinds and argument sources (csrc/stream_ops.cuh); EVICT and REFILL
# occur in replay programs only.
PROD, PAIR, COUNT, MUX, FILL, SPILL, EVICT, REFILL = range(8)
POOL, STAGED, HOUSE, LOG = range(4)
_KIND = {"prod": PROD, "pair": PAIR, "count": COUNT, "mux": MUX,
         "fill": FILL}
_SRC = {"pool": POOL, "stage": STAGED, "house": HOUSE}
#: Count-DP states a kernel thread keeps in its own local array
#: (``csrc/stream_ops.cuh``); a program whose :func:`count_window` forms
#: need more runs the same DP over a device-memory scratch
#: (:func:`_dp_scratch`), allocated for that program only.
MAX_COUNT_STATES = 128

#: Shared memory one block may use on an H100 (227 KB, opt-in above 48 KB).
SMEM_BYTES = 232_448
#: Records per chunk of the stream kernel's shared-memory record ring
#: (``csrc/stream.cu``).
REC_CHUNK = 128
#: Record kinds (``csrc/stream.cu``): padding, a mux over a staged decision
#: variable and two pool rows (every BDD op), any other op of the table.
R_NOP, R_MUX, R_OP = range(3)
#: Trials per thread of the step kernel by value type (``csrc/stream.cu``
#: kTrials): 2 in float32, the fastest of K = 1, 2, 4 on the BDD slice's
#: module (``PERF.md``); 1 in float64.  Its blocks run 128 threads.
_STEP_K = {torch.float32: 2, torch.float64: 1}
#: Trials and pool rows below this bound (``csrc/stream.cu``'s 32-bit row
#: offsets multiply out to 64 bits).
_MAX_STEP_TRIALS = 1 << 31
#: The most trials one level-parallel block takes.
_LEVEL_TILE = 32
#: Threads per block of the one-trial-per-thread stream kernel and of the
#: level-parallel kernels (``csrc/stream.cu`` OPS_THREADS and
#: LEVEL_THREADS, ``csrc/adjoint.cu``): they size the count-DP scratch.
_OPS_THREADS = 128
_LEVEL_THREADS = 256
#: The replay forward's prefetch ring (``csrc/replay_ops.cuh``): each
#: thread keeps its next basic-stream and eviction-log reads in flight in
#: ``depth`` shared-memory rows of its block.  The depth is the smallest
#: of ``REPLAY_RING_DEPTHS`` (the kernel's instantiations:
#: ``cp.async.wait_group`` takes a constant) whose rows of the block's
#: trials hold ``REPLAY_RING_BYTES``, the bytes an SM keeps in flight.
REPLAY_RING_DEPTHS = (8, 16, 32, 64)
REPLAY_RING_BYTES = 24_576
#: int32 words per chunk of the replay forward's op stream (more for a
#: program whose longest op needs them); two chunks and their two
#: mbarriers sit in shared memory.
REPLAY_CHUNK_WORDS = 1024
_REPLAY_BARRIER_BYTES = 16
#: The most pool plus resident slots a replay program may have: what one
#: block of one warp (32 float32 trials) holds beside the shallowest ring
#: and the op-stream chunks.
REPLAY_SLOTS = (SMEM_BYTES - _REPLAY_BARRIER_BYTES - 8 * REPLAY_CHUNK_WORDS
                ) // (32 * 4) - REPLAY_RING_DEPTHS[0]
#: The most pool slots a spill program may have: the ring kernel's
#: bound, as for replay (a spill program has no resident tier).
SPILL_SLOTS = REPLAY_SLOTS
#: Sizes the default replay pool: ``SMEM_BYTES // (4 * REPLAY_TRIALS)`` =
#: 56 slots.  The ring kernel's time follows the trials an SM holds, and
#: a 56-slot pool lets two 256-trial blocks share an SM at 65,536 trials:
#: on the 65k tree as fast as 28 or 14 slots, with fewer evictions, and
#: faster than any larger pool (``tools/replay_occupancy.py``,
#: ``PERF.md``).
REPLAY_TRIALS = 1024
#: Sizes the default spill pool: ``SMEM_BYTES // (4 * SPILL_TRIALS)``
#: slots.  Spill runs the replay forward's ring kernel, whose time follows
#: the trials an SM holds; the value is the fastest of
#: ``tools/replay_occupancy.py --spill``'s sweep on the 65k tree
#: (``PERF.md``).
SPILL_TRIALS = 1024
#: Streaming multiprocessors of an H100 SXM: the replay forward narrows
#: its blocks until the trials spread over all of them.
_SMS = 132
#: The replay builders' TPU VMEM budget has no meaning on the card (the
#: port checks shared memory on the built program): one no program
#: reaches.
_NO_VMEM_BUDGET = 1 << 62


def count_window(lo: int, hi: int, n: int) -> tuple[int, int, bool, int]:
    """The count-DP form of a window ``[lo, hi]`` over ``n`` arguments:
    ``(lo, hi, complement, states)``, the one rule every encoder applies.

    A window with ``hi >= n`` is upper-open, P(count >= lo): ``lo + 1``
    states absorbing at ``lo`` (returned with ``hi = n``).  A bounded one
    needs ``hi + 2``.  Counting the false arguments instead turns
    ``[lo, hi]`` into ``[n - hi, n - lo]``; the cheaper of the two forms
    wins (``complement`` then asks the encoder to flip every argument's
    complement flag).  An empty window becomes ``[1, 0]`` (value 0, two
    states).  Every window has a form; one beyond
    :data:`MAX_COUNT_STATES` runs its DP in device memory.
    """
    lo, hi, n = max(int(lo), 0), int(hi), int(n)
    if lo > min(hi, n):
        return 1, 0, False, 2

    def form(a: int, b: int) -> tuple[int, int]:
        return (a, n, a + 1) if b >= n else (a, b, b + 2)
    direct = form(lo, hi)
    comp = form(max(n - hi, 0), n - lo)
    flip = comp[2] < direct[2]
    w_lo, w_hi, states = comp if flip else direct
    return w_lo, w_hi, flip, states


def _count_row(aux, n_args: int, args: list, begin: int):
    """``(aux0, aux1, states)`` of a count op whose arguments are rows
    ``begin:`` of ``args`` (flags flipped in place for the complement
    form)."""
    lo, hi, flip, states = count_window(aux[0], aux[1], n_args)
    if flip:
        for row in args[begin:begin + n_args]:
            row[2] ^= 1
    return lo, hi, states


def compile_stream(tree: CompiledTree, chunk_tiles: int = 256,
                   n_bufs: int = 3) -> StreamProgram:
    """Schedule ``tree`` for streaming (raises ``LogicError`` when no
    schedule exists)."""
    return build_stream_schedule(tree, chunk_tiles=chunk_tiles,
                                 n_bufs=n_bufs)


@dataclasses.dataclass(kw_only=True)
class UncappedProgram(StreamProgram):
    """A program :func:`_uncapped_program` allocated: a ``StreamProgram``
    (the TPU scheduler's, shared with the JAX package) whose pool slots
    ``out_slots`` hold its outputs at the end, in root order, the first
    ``top_slot``."""

    out_slots: list[int]


def _uncapped_program(exec_rows, n_b: int, n_h: int,
                      tops: list[int]) -> UncappedProgram:
    """Allocate ``exec_rows`` (value slots: staged inputs below ``n_b``,
    house events below ``n_b + n_h``, gates above) without the TPU's caps.

    Every input the rows read gets its own staged row, in first-use
    order (one staging chunk, no spills); gate values take linear-scan
    pool slots, freed after their last reader — the shared scheduler's
    allocation without its staging ring, so wherever that scheduler
    spills nothing both give the same tables.  The slots of ``tops``
    are never freed: ``top_slot`` holds the first, ``out_slots`` each of
    them in order.
    """
    stage_pos: dict[int, int] = {}
    last_read: dict[int, int] = {}
    for g, (_k, _out, args, _aux) in enumerate(exec_rows):
        for slot, _flag in args:
            if slot < n_b:
                stage_pos.setdefault(slot, len(stage_pos))
            elif slot >= n_b + n_h:
                last_read[slot] = g
    kept = set(tops)

    def loc(s: int):
        if s < n_b:
            return ("stage", 0, stage_pos[s])
        if s < n_b + n_h:
            return ("house", s - n_b)
        return ("pool", pool_of[s])

    free: list[int] = []
    n_slots = 0
    pool_of: dict[int, int] = {}
    frees_at: dict[int, list[int]] = {}
    ops: list = [("start", 0, 0), ("wait", 0, 0)]
    for g, (kind, out, args, aux) in enumerate(exec_rows):
        locs = [(loc(s), flag) for s, flag in args]
        if free:
            pool_of[out] = free.pop()
        else:
            pool_of[out] = n_slots
            n_slots += 1
        ops.append(("gate", kind, pool_of[out], locs, aux))
        if out not in kept:
            if out in last_read:
                frees_at.setdefault(last_read[out], []).append(out)
            else:
                free.append(pool_of[out])
        free += [pool_of[v] for v in frees_at.pop(g, ())]
    n_staged = len(stage_pos)
    return UncappedProgram(
        ops=ops, basic_perm=np.fromiter(stage_pos, np.int64, n_staged),
        n_basic=n_staged, n_basic_pad=n_staged, chunk_tiles=n_staged,
        n_chunks=1, n_bufs=1, pool_slots=n_slots, top_slot=pool_of[tops[0]],
        nnz=sum(len(r[2]) for r in exec_rows), n_house=n_h,
        out_slots=[pool_of[t] for t in tops])


def _batched_rows(rows: list, width: int) -> list:
    """``rows`` (exec rows in a valid order) rescheduled into steps of up
    to ``width`` mutually independent rows: list scheduling that fills
    each step with the ready rows of lowest original index, so the order
    stays close to the original (on the BDD slice's module the pool stays
    at 175 slots against 176 depth-first, with steps of 8 97 % full).
    Every row keeps its own arithmetic, so values do not change."""
    import heapq
    out_of = {r[1]: i for i, r in enumerate(rows)}
    waits = [0] * len(rows)
    users: list = [[] for _ in rows]
    for i, (_k, _out, args, _aux) in enumerate(rows):
        deps = {out_of[slot] for slot, _f in args if slot in out_of}
        waits[i] = len(deps)
        for d in deps:
            users[d].append(i)
    ready = [i for i, w in enumerate(waits) if w == 0]
    heapq.heapify(ready)
    order: list = []
    while ready:
        step = [heapq.heappop(ready) for _ in range(min(width, len(ready)))]
        order += step
        for i in step:
            for u in users[i]:
                waits[u] -= 1
                if waits[u] == 0:
                    heapq.heappush(ready, u)
    return [rows[i] for i in order]


def compile_bdd_stream(bdd, batch: int = 1) -> StreamProgram:
    """Schedule exact ROBDD evaluation for the kernels: one fused mux per
    Shannon node, in the shared scheduler's depth-first order, so every
    op computes what the JAX package's stream computes.

    ``batch > 1`` reschedules that order into steps of up to ``batch``
    independent muxes (:func:`_batched_rows`), the steps the stream
    kernel loads whole before it stores; every node's value is unchanged,
    bit for bit.  The shared scheduler's caps (a 13 MiB VMEM pool, 400k
    unrolled edges) belong to the TPU kernel; here the op table is data,
    so none applies (:func:`_uncapped_program`).  Raises ``LogicError``
    only for a constant BDD or one without raw node arrays.
    """
    from ..compiler.schedule import _dfs_exec_rows
    if bdd.raw_var is None:
        raise LogicError("CompiledBdd is missing raw node arrays")
    root = bdd.resolved_root()
    if root <= 1:
        raise LogicError("constant BDD: nothing to stream")
    var_arr, low_arr, high_arr = bdd.raw_var, bdd.raw_low, bdd.raw_high
    reach: set[int] = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if n <= 1 or n in reach:
            continue
        reach.add(n)
        stack += [int(low_arr[n]), int(high_arr[n])]
    used_vars = sorted({int(var_arr[n]) for n in reach})
    local_of_var = {v: i for i, v in enumerate(used_vars)}
    n_b = len(used_vars)
    rows = [("fill", n_b, [], 0.0), ("fill", n_b + 1, [], 1.0)] + [
        ("mux", n_b + n, [(local_of_var[int(var_arr[n])], False),
                          (n_b + int(high_arr[n]), False),
                          (n_b + int(low_arr[n]), False)], None)
        for n in sorted(reach)]
    exec_rows = _dfs_exec_rows(rows, n_b, 0, n_b + root)
    if batch > 1:
        exec_rows = _batched_rows(exec_rows, batch)
    program = _uncapped_program(exec_rows, n_b, 0, [n_b + root])
    program.stage_cols = np.array([bdd.slot_of_var[v] for v in used_vars],
                                  dtype=np.int64)
    return program


#: Muxes per step of the BDD programs the kernels run (the stream
#: kernel's step at one trial per thread; two or four trials per thread
#: take half or a quarter of each step).
BDD_BATCH = 8


def bdd_stream_encoding(bdd) -> "EncodedStream":
    """The encoded :func:`compile_bdd_stream` program of ``bdd`` in steps
    of ``BDD_BATCH``, cached on the BDD so importance (f64) and
    uncertainty (f32) schedule and encode it once."""
    enc = getattr(bdd, "_stream_encoding", None)
    if enc is None:
        enc = bdd._stream_encoding = encode_stream(
            compile_bdd_stream(bdd, batch=BDD_BATCH))
    return enc


def compile_tree_stream(tree: CompiledTree,
                        roots: list[int] | None = None
                        ) -> UncappedProgram:
    """Schedule a compiled tree's top cone for the kernels: the tree
    counterpart of :func:`compile_bdd_stream`.

    Gates run in the shared scheduler's depth-first order
    (``compiler/schedule._dfs_exec_rows``), so every op computes what the
    JAX package's stream computes.  None of the TPU's caps applies (no
    400k-edge limit, no staging ring, no VMEM budget): every reachable
    basic event keeps its own staged row in first-use order and gate
    values take linear-scan pool slots in device memory.  Raises
    ``LogicError`` only when the tree has no anchored top or its cone
    reads no basic event.

    ``roots`` (gate slots) asks for one program of several roots, such
    as an event tree's sequences: the depth-first orders of the roots in
    turn, each gate where it first appears, so a gate shared by roots
    runs once (the order one walk over the roots with one visited set
    gives, since a gate visited before brings only gates visited before);
    the roots' slots are never freed, and ``out_slots`` lists them in
    root order.  Such a program may stage no basic event.
    """
    from ..compiler.schedule import _dfs_exec_rows, _emit_gate_ops
    n_b, n_h = tree.n_basic, tree.n_house
    rows = _emit_gate_ops(tree)
    if roots is None:
        if tree.top_index is None:
            raise LogicError("stream schedule needs an anchored top event")
        program = _uncapped_program(
            _dfs_exec_rows(rows, n_b, n_h, tree.top_index), n_b, n_h,
            [tree.top_index])
        if not program.n_basic:
            raise LogicError("stream schedule needs at least one basic "
                             "event")
        return program
    gates = {row[1] for row in rows}
    if not roots or not set(roots) <= gates:
        raise LogicError("a multi-root stream program takes gate slots")
    exec_rows: list = []
    done: set[int] = set()
    for root in roots:
        for row in _dfs_exec_rows(rows, n_b, n_h, root):
            if row[1] not in done:
                done.add(row[1])
                exec_rows.append(row)
    return _uncapped_program(exec_rows, n_b, n_h, list(roots))


def tree_stream_encoding(tree: CompiledTree) -> "EncodedStream":
    """The encoded :func:`compile_tree_stream` program of ``tree``, cached
    on the tree so importance (f64) and uncertainty (f32) schedule and
    encode it once."""
    enc = getattr(tree, "_stream_encoding", None)
    if enc is None:
        enc = tree._stream_encoding = encode_stream(compile_tree_stream(tree))
    return enc


@dataclasses.dataclass
class EncodedStream:
    """A stream program as flat tables (``csrc/stream_ops.cuh``)."""

    ops: np.ndarray        # (n_ops, 7) int32
    args: np.ndarray       # (n_args, 5) int32
    fill: np.ndarray       # (n_ops,) float32
    n_log: int             # value-log rows (one per gate/fill op)
    n_basic: int           # staged rows
    n_house: int
    pool_slots: int
    top_slot: int
    max_count_states: int  # largest count DP (count_window) in the program
    staged_cols: np.ndarray  # (n_basic,) input column of each staged row
    #: (n_out,) int32 pool slots the one-trial-per-thread kernel copies
    #: out, in root order; the first is ``top_slot`` (a single-top
    #: program: it alone).
    out_slots: np.ndarray
    _cache: dict = dataclasses.field(default_factory=dict,
                                            repr=False)

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def tables(self, device: torch.device):
        """(ops, args, fill) as tensors on ``device`` (cached); ``ops``
        goes up in one copy with ``out_slots`` (:meth:`outputs`)."""
        key = str(device)
        if key not in self._cache:
            head = to_device(np.concatenate([self.ops.ravel(),
                                             self.out_slots]), device)
            n = self.ops.size
            self._cache[key] = (head[:n].view(self.ops.shape),
                                to_device(self.args, device),
                                to_device(self.fill, device))
            self._cache[f"outputs:{device}"] = head[n:]
        return self._cache[key]

    def outputs(self, device: torch.device) -> torch.Tensor:
        """``out_slots`` as an int32 tensor on ``device`` (cached, put
        there with the tables)."""
        self.tables(device)
        return self._cache[f"outputs:{device}"]

    def plain_ops(self):
        """The tables as Python lists for the plain versions' loops."""
        if "plain" not in self._cache:
            self._cache["plain"] = (
                self.ops.tolist(), self.args.tolist(),
                [float(v) for v in self.fill])
        return self._cache["plain"]


def encode_stream(program) -> EncodedStream:
    """Encode a ``StreamProgram`` (this package's or the JAX package's;
    its outputs an :class:`UncappedProgram`'s ``out_slots``, else its top).

    ``start``/``wait`` DMA ops disappear; a ``("stage", buf, off)``
    location becomes staged row ``chunk * chunk_tiles + off`` where
    ``chunk`` is the chunk the last ``wait`` put in ``buf``; a spill
    becomes a SPILL op copying that row into its pool slot.  Each argument
    also records where the backward reads its value: the log row of the
    op that last wrote its pool slot, its staged row (staged or spilled
    basics), or its house constant.
    """
    ct = program.chunk_tiles
    buf_chunk: dict[int, int] = {}
    writer: dict[int, tuple[int, int]] = {}   # pool slot -> (src, index)
    ops, args, fill = [], [], []
    n_log = 0
    max_states = 0
    for op in program.ops:
        tag = op[0]
        if tag == "start":
            continue
        if tag == "wait":
            buf_chunk[op[2]] = op[1]
            continue
        if tag == "spill":
            _t, buf, off, slot = op
            row = buf_chunk[buf] * ct + off
            ops.append([SPILL, slot, len(args), len(args) + 1, 0, 0, -1])
            args.append([STAGED, row, 0, STAGED, row])
            fill.append(0.0)
            writer[slot] = (STAGED, row)
            continue
        _t, kind, out_slot, locs, aux = op
        begin = len(args)
        for loc, flag in locs:
            src = _SRC[loc[0]]
            if src == STAGED:
                index = buf_chunk[loc[1]] * ct + loc[2]
                back = (STAGED, index)
            elif src == HOUSE:
                index = loc[1]
                back = (HOUSE, index)
            else:
                index = loc[1]
                back = writer[index]
            args.append([src, index, int(bool(flag)), *back])
        aux0 = aux1 = 0
        value = 0.0
        if kind in ("prod", "pair"):
            aux0 = int(bool(aux))
        elif kind == "count":
            aux0, aux1, states = _count_row(aux, len(locs), args, begin)
            max_states = max(max_states, states)
        elif kind == "fill":
            value = float(aux)
        ops.append([_KIND[kind], out_slot, begin, len(args), aux0, aux1,
                    n_log])
        fill.append(value)
        writer[out_slot] = (LOG, n_log)
        n_log += 1
    out_slots = program.out_slots if isinstance(program, UncappedProgram) \
        else [program.top_slot]
    perm = np.asarray(program.basic_perm, dtype=np.int64)
    cols = perm if program.stage_cols is None \
        else np.asarray(program.stage_cols, dtype=np.int64)[perm]
    return EncodedStream(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.asarray(fill, dtype=np.float32), n_log=n_log,
        n_basic=program.n_basic, n_house=program.n_house,
        pool_slots=max(program.pool_slots, 1), top_slot=program.top_slot,
        max_count_states=max_states, staged_cols=cols,
        out_slots=np.asarray(out_slots, dtype=np.int32))


def stage_basic(enc: EncodedStream, values: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(n_trials, >= max(staged_cols)+1)`` -> staged ``(n_basic,
    n_trials)`` of ``dtype``, in staging order.

    Plain indexing, so autograd maps a staged gradient back onto
    ``values``.  For BDD programs ``values`` is the global value matrix
    and the program's ``stage_cols`` pick its decision variables.
    """
    cols = to_device(enc.staged_cols, values.device)
    return values.to(dtype)[:, cols].T.contiguous()


def unstage_basic(enc: EncodedStream, staged: torch.Tensor,
                  n_cols: int) -> torch.Tensor:
    """Staged ``(n_basic, n_trials)`` -> ``(n_trials, n_cols)`` with each
    staged row summed into its input column (the adjoint of
    :func:`stage_basic`; columns the program never reads stay zero)."""
    out = torch.zeros(staged.shape[1], n_cols, dtype=staged.dtype,
                      device=staged.device)
    cols = torch.from_numpy(enc.staged_cols).to(staged.device)
    return out.index_add_(1, cols, staged.T)


def house_tensor(enc: EncodedStream, house, device,
                 dtype=torch.float32) -> torch.Tensor:
    """House-event states as the kernels read them: rounded to f32 (the
    TPU kernels' constants), then ``dtype``, on ``device``."""
    house = np.asarray(house, dtype=np.float32).reshape(-1)
    if len(house) != enc.n_house:
        raise LogicError(f"program reads {enc.n_house} house events, got "
                         f"{len(house)} states")
    # One spare element keeps the pointer valid for house-free programs.
    return to_device(np.concatenate([house, [0.0]]).astype(np.float32),
                     device).to(dtype)


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_staged(enc: EncodedStream, staged: torch.Tensor) -> None:
    if staged.ndim != 2 or staged.shape[0] != enc.n_basic:
        raise LogicError(f"staged input must be ({enc.n_basic}, n_trials), "
                         f"got {tuple(staged.shape)}")
    if staged.dtype not in _SUFFIX:
        raise LogicError(f"stream programs run in float32 or float64, got "
                         f"{staged.dtype}")


# ---------------------------------------------------------------------------
# Plain PyTorch version: a loop over the encoded ops, vectorised over trials.
# ---------------------------------------------------------------------------

def _plain_value(op, fill_value: float, args, load, staged: torch.Tensor):
    """The value of one encoded op in plain torch, its arguments read
    through ``load`` (the one plain body of ``csrc/stream_ops.cuh``'s
    ``eval_op``, shared by the stream, fused and replay plain versions)."""
    kind, _out, b, e, aux0, aux1, _row = op
    T, dtype, device = staged.shape[1], staged.dtype, staged.device
    if kind == MUX:
        p, hi, lo = (load(args[j]) for j in range(b, b + 3))
        return p * hi + (1.0 - p) * lo
    if kind == PROD:
        v = load(args[b])
        for j in range(b + 1, e):
            v = v * load(args[j])
        return 1.0 - v if aux0 else v
    if kind == PAIR:
        a, c = load(args[b]), load(args[b + 1])
        v = a + c - 2.0 * a * c
        return 1.0 - v if aux0 else v
    if kind == COUNT:
        # Absorbing at ``cap``: lo for an upper-open window (hi >= n, the
        # value dp[lo]), else hi + 1 (count_window's forms).
        # States are rows of one (cap + 1, T) tensor: each update is the
        # kernel's per-state arithmetic, element for element.
        is_open = aux1 >= e - b
        cap = aux0 if is_open else aux1 + 1
        dp = torch.zeros((cap + 1, T), dtype=dtype, device=device)
        dp[0] = 1.0
        for j in range(b, e if cap >= 1 else b):
            x = load(args[j])
            nx = 1.0 - x
            dp = torch.cat([dp[:1] * nx, dp[1:cap] * nx + dp[:cap - 1] * x,
                            (dp[cap] + dp[cap - 1] * x)[None]])
        if is_open:
            return dp[aux0]
        v = torch.zeros(T, dtype=dtype, device=device)
        if aux0 <= aux1:
            v = dp[aux0]
            for k in range(aux0 + 1, aux1 + 1):
                v = v + dp[k]
        return v
    if kind == FILL:
        return torch.full((T,), fill_value, dtype=torch.float32,
                          device=device).to(dtype)
    return load(args[b])   # SPILL: its one staged argument


def stream_forward_plain(enc: EncodedStream, staged: torch.Tensor,
                         house: torch.Tensor, with_log: bool = False):
    """The kernel's arithmetic in plain torch (any dtype, any device,
    differentiable by autograd).  Returns ``(top, log or None)``."""
    pool, log = _plain_pool(enc, staged, house, with_log)
    return pool[enc.top_slot], log


def stream_roots_forward_plain(enc: EncodedStream, staged: torch.Tensor,
                               house: torch.Tensor) -> torch.Tensor:
    """The multi-root kernel's arithmetic in plain torch: ``(n_out,
    n_trials)``, row ``k`` the value of pool slot ``enc.out_slots[k]``
    after the last op."""
    pool, _log = _plain_pool(enc, staged, house, False)
    return torch.stack([pool[s] for s in enc.out_slots.tolist()])


def _plain_pool(enc: EncodedStream, staged: torch.Tensor,
                house: torch.Tensor, with_log: bool):
    """Every op of ``enc`` in order: ``(pool, log or None)``, the pool a
    list of each slot's last value."""
    ops, args, fill = enc.plain_ops()
    T = staged.shape[1]
    pool: list = [None] * enc.pool_slots
    log: list = [None] * enc.n_log if with_log else None

    def load(a):
        src, idx, flag = a[0], a[1], a[2]
        if src == POOL:
            v = pool[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if flag else v

    for o, op in enumerate(ops):
        v = _plain_value(op, fill[o], args, load, staged)
        pool[op[1]] = v
        if with_log and op[6] >= 0:
            log[op[6]] = v
    if with_log:
        return pool, (torch.stack(log) if log else
                      staged.new_zeros((0, T)))
    return pool, None


# ---------------------------------------------------------------------------
# The trial-parallel kernel's records and shared-memory plan.
# ---------------------------------------------------------------------------

def _step(dtype: torch.dtype) -> int:
    """Records per step of the stream kernel (``csrc/stream.cu`` kStep):
    8 mux chains in flight per thread."""
    return 8 // _STEP_K[dtype]


def pack_records(enc: EncodedStream, step: int) -> tuple:
    """The op table as the stream kernel's records, in steps of ``step``
    (cached): ``(records (n, 4) int32, rec_op (n,) int32)``, one int4 and
    its op index (-1 for padding) per record, ``n`` whole chunks of
    ``REC_CHUNK`` plus one chunk of NOPs.

    A mux whose arguments are a staged row (p) and two pool slots (hi,
    lo), none complemented — every op of a BDD program — packs whole:
    ``(R_MUX << 24 | out, p row, hi slot, lo slot)``.  Consecutive such
    muxes share a step while none reads a slot another of the step
    writes (the kernel loads the whole step before it stores); a step is
    padded with muxes into the scratch row ``pool_slots``.  Any other op
    is ``(R_OP << 24 | out, 0, 0, 0)``, its step padded with NOPs, and
    the kernel reads its row of the general table.
    """
    key = f"records:{step}"
    if key in enc._cache:
        return enc._cache[key]
    ops, args = enc.ops, enc.args
    if len(ops) and int(ops[:, 1].max()) >= (1 << 24) - 1:
        raise LogicError("stream records hold pool slots below 2^24 - 1")
    dummy = [(R_MUX << 24) | enc.pool_slots, 0, enc.pool_slots,
             enc.pool_slots]
    recs: list = []
    rec_op: list = []
    cur: list = []
    cur_mux = False
    written: set = set()

    def close():
        pad = dummy if cur_mux else [R_NOP << 24, 0, 0, 0]
        for _ in range(step - len(cur)):
            cur.append((pad, -1))
        for rec, o in cur:
            recs.append(rec)
            rec_op.append(o)
        cur.clear()
        written.clear()

    for o, (kind, out, b, _e) in enumerate(ops[:, :4].tolist()):
        is_mux = kind == MUX and args[b, 0] == STAGED and \
            args[b + 1, 0] == POOL and args[b + 2, 0] == POOL and \
            not (args[b, 2] or args[b + 1, 2] or args[b + 2, 2])
        if is_mux:
            hi, lo = int(args[b + 1, 1]), int(args[b + 2, 1])
            if cur and (not cur_mux or len(cur) == step or
                        hi in written or lo in written):
                close()
            cur_mux = True
            cur.append(([(R_MUX << 24) | out, int(args[b, 1]), hi, lo], o))
            written.add(out)
        else:
            if cur and (cur_mux or len(cur) == step):
                close()
            cur_mux = False
            cur.append(([(R_OP << 24) | out, 0, 0, 0], o))
    if cur:
        close()
    n_pad = -len(recs) % REC_CHUNK    # whole steps of padding muxes
    recs += [dummy] * n_pad
    rec_op += [-1] * n_pad
    n = len(recs) + REC_CHUNK
    out_recs = np.zeros((n, 4), dtype=np.int32)
    out_recs[:len(recs)] = recs
    out_ops = np.full(n, -1, dtype=np.int32)
    out_ops[:len(rec_op)] = rec_op
    enc._cache[key] = (out_recs, out_ops)
    return enc._cache[key]


def stream_variant(enc: EncodedStream) -> str:
    """The stream forward's kernel for ``enc``: ``"steps"`` (the step
    kernel) for a program of muxes and fills (every BDD program),
    ``"ops"`` (one trial per thread over the general op table) for any
    other (tree programs: products, pairs, counts)."""
    return "steps" if np.isin(enc.ops[:, 0], (MUX, FILL)).all() else "ops"


# ---------------------------------------------------------------------------
# The level schedule of the level-parallel logged forward and adjoint.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelSchedule:
    """An encoded program's ops by level, with each value's consumers.

    An op's level is 1 + the highest level of the ops whose values it
    reads (the ops that last wrote its pool arguments: gates, whose log
    rows it reads, and spills), 0 when it reads none.  ``order`` lists the
    ops level by level (op order within a level), ``level_ptr`` where
    each level starts.  ``cons[cons_ptr[o]:cons_ptr[o + 1]]`` are the
    argument rows (edges) that read op ``o``'s value, sorted by consumer
    op descending, then position ascending: the order in which the
    reverse walk accumulates that value's adjoint; ``stage_cons`` the
    same for each staged row's direct reads.  ``top_op`` last writes the
    top slot; the top value is log row ``top_idx`` (``top_src == LOG``)
    or staged row ``top_idx``.
    """

    order: np.ndarray
    level_ptr: np.ndarray
    cons_ptr: np.ndarray
    cons: np.ndarray
    stage_ptr: np.ndarray
    stage_cons: np.ndarray
    top_op: int
    top_src: int
    top_idx: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_levels(self) -> int:
        return len(self.level_ptr) - 1

    def tables(self, device: torch.device):
        """The int32 arrays on ``device`` (cached): order, level_ptr,
        cons_ptr, cons, stage_ptr, stage_cons (the last two lists padded
        by one entry, so no pointer is null)."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                for a in (self.order, self.level_ptr, self.cons_ptr,
                          np.r_[self.cons, 0], self.stage_ptr,
                          np.r_[self.stage_cons, 0]))
        return self._cache[key]


def _csr(keys: np.ndarray, ops_of: np.ndarray, rows: np.ndarray, n: int):
    """Rows grouped by key, each group by op descending then row."""
    order = np.lexsort((rows, -ops_of, keys))
    ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr, rows[order].astype(np.int32)


def schedule_levels(ops: np.ndarray, args: np.ndarray, producer: np.ndarray,
                    n_basic: int, top_op: int, top_src: int,
                    top_idx: int) -> LevelSchedule:
    """The :class:`LevelSchedule` of an op table whose argument row ``j``
    reads the value of op ``producer[j]`` (-1: a staged row or a house
    constant).  Producers precede their readers."""
    n_ops, n_args = len(ops), len(args)
    op_of = np.repeat(np.arange(n_ops), ops[:, 3] - ops[:, 2])
    if len(op_of) != n_args or (n_args and np.any(
            ops[1:, 2] != ops[:-1, 3])):
        raise LogicError("level schedules need contiguous argument rows")
    level = np.zeros(n_ops, dtype=np.int64)
    for o, (b, e) in enumerate(ops[:, 2:4].tolist()):
        lv = -1
        for w in producer[b:e].tolist():
            if w >= 0 and level[w] > lv:
                lv = int(level[w])
        level[o] = lv + 1
    order = np.argsort(level, kind="stable").astype(np.int32)
    level_ptr = np.zeros(int(level.max(initial=-1)) + 2, dtype=np.int32)
    np.cumsum(np.bincount(level), out=level_ptr[1:])
    rows = np.arange(n_args)
    read = producer >= 0
    cons_ptr, cons = _csr(producer[read], op_of[read], rows[read], n_ops)
    staged = args[:, 0] == STAGED
    stage_ptr, stage_cons = _csr(args[staged, 1].astype(np.int64),
                                 op_of[staged], rows[staged], n_basic)
    return LevelSchedule(order, level_ptr, cons_ptr, cons, stage_ptr,
                         stage_cons, top_op, top_src, top_idx)


def level_schedule(enc: EncodedStream) -> LevelSchedule:
    """The level schedule of ``enc`` (cached on the encoding, as
    :func:`tree_stream_encoding` caches the encoding): each pool
    argument's producer is the op that last wrote its slot (a gate or a
    spill)."""
    if "levels" in enc._cache:
        return enc._cache["levels"]
    ops, args = enc.ops, enc.args
    producer = np.full(len(args), -1, dtype=np.int64)
    writer: dict[int, int] = {}
    for o, (_k, out, b, e) in enumerate(ops[:, :4].tolist()):
        for j in range(b, e):
            if args[j, 0] == POOL:
                producer[j] = writer[int(args[j, 1])]
        writer[out] = o
    top_op = writer[enc.top_slot]
    if ops[top_op, 6] >= 0:
        top_src, top_idx = LOG, int(ops[top_op, 6])
    else:   # a spilled basic
        top_src, top_idx = STAGED, int(args[ops[top_op, 2], 1])
    sched = schedule_levels(ops, args, producer, enc.n_basic, top_op,
                            top_src, top_idx)
    enc._cache["levels"] = sched
    return sched


def level_tile(n_trials: int) -> int:
    """Trials per block of the level-parallel kernels: enough blocks to
    give each of the card's 132 SMs one, at most ``_LEVEL_TILE``."""
    return max(1, min(_LEVEL_TILE, -(-n_trials // 132)))


def stream_forward_levels_plain(enc: EncodedStream, staged: torch.Tensor,
                                house: torch.Tensor):
    """The level-parallel logged forward in plain torch: the ops of each
    level in :func:`level_schedule` order, every argument read by its
    backward source (log row, staged row, house), each value written
    straight to its log row.  Returns ``(top, log)``, bit-equal to
    :func:`stream_forward_plain` with the log."""
    sched = level_schedule(enc)
    ops, args, fill = enc.plain_ops()
    T = staged.shape[1]
    log: list = [None] * enc.n_log

    def x(a):
        src, idx = a[3], a[4]
        if src == LOG:
            v = log[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if a[2] else v

    for o in sched.order.tolist():
        op = ops[o]
        if op[6] >= 0:
            log[op[6]] = _plain_value(op, fill[o], args, x, staged)
    top = log[sched.top_idx] if sched.top_src == LOG \
        else staged[sched.top_idx]
    return top, (torch.stack(log) if log else staged.new_zeros((0, T)))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_cuda(dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype \
                or not t.is_contiguous():
            raise LogicError(f"stream kernel takes contiguous {dtype} CUDA "
                             f"tensors, got {t.dtype} on {t.device}")


def _dp_scratch(enc: EncodedStream, blocks: int, threads: int,
                like: torch.Tensor):
    """The count-DP scratch of a kernel launch of ``blocks`` x
    ``threads``: ``(states, blocks * threads)`` of ``like``'s dtype and
    device, the thread index contiguous (``csrc/stream_ops.cuh``
    dp_scratch), for a program whose widest count form exceeds
    :data:`MAX_COUNT_STATES`; else None (the threads' local arrays hold
    every DP).  Keep it alive until the launch is queued."""
    if enc.max_count_states <= MAX_COUNT_STATES:
        return None
    return torch.empty((enc.max_count_states, blocks * threads),
                       dtype=like.dtype, device=like.device)


def stream_forward(enc: EncodedStream, staged: torch.Tensor, house,
                   with_log: bool = False):
    """Run the program on staged ``(n_basic, n_trials)`` input.

    Returns ``(top (n_trials,), log (n_log, n_trials) or None)``.  CPU
    tensors run :func:`stream_forward_plain`; CUDA tensors launch a
    kernel of ``csrc/stream.cu`` or raise.  Without the log: the kernel
    :func:`stream_variant` picks.  With it: the level-parallel kernel.
    """
    _check_staged(enc, staged)
    device, dtype = staged.device, staged.dtype
    house_t = house_tensor(enc, house, device, dtype)
    if device.type != "cuda":
        return stream_forward_plain(enc, staged, house_t, with_log)
    lib = load_library()
    staged = staged.contiguous()
    _check_cuda(dtype, staged)
    T = staged.shape[1]
    ops, args, fill = enc.tables(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    top = torch.empty(T, dtype=dtype, device=device)
    if with_log:
        log = torch.empty((enc.n_log, T), dtype=dtype, device=device)
        sched = level_schedule(enc)
        order, level_ptr = sched.tables(device)[:2]
        tile = level_tile(T)
        smem_log = enc.n_log * tile * staged.element_size() <= SMEM_BYTES
        dp = _dp_scratch(enc, -(-T // tile), _LEVEL_THREADS, staged)
        COUNTERS["launch.stream_log"] += 1
        code = getattr(lib, f"canopy_stream_level_forward_{_SUFFIX[dtype]}")(
            ops.data_ptr(), fill.data_ptr(), args.data_ptr(),
            order.data_ptr(), level_ptr.data_ptr(), sched.n_levels,
            staged.data_ptr(), house_t.data_ptr(), log.data_ptr(),
            top.data_ptr(), T, tile, enc.n_log, sched.top_src, sched.top_idx,
            int(smem_log), _ptr(dp), stream)
        _raise_on(lib, code, "stream level forward")
        return top, log
    variant = stream_variant(enc)
    if variant == "ops":
        COUNTERS["launch.stream"] += 1
        _launch_ops(lib, enc, staged, house_t, top,
                    enc.outputs(device)[:1])
        return top, None
    width = 128 * _STEP_K[dtype]
    t_pad = -(-T // width) * width
    if t_pad >= _MAX_STEP_TRIALS:
        raise LogicError(f"the stream kernel runs below {_MAX_STEP_TRIALS} "
                         f"trials per call, got {T}")
    step = _step(dtype)
    key = f"records:{step}:{device}"
    if key not in enc._cache:
        enc._cache[key] = tuple(to_device(a, device)
                                for a in pack_records(enc, step))
    recs, rec_op = enc._cache[key]
    gpool = torch.empty((enc.pool_slots + 1, t_pad), dtype=dtype,
                        device=device)
    COUNTERS["launch.stream"] += 1
    code = getattr(lib, f"canopy_stream_forward_{_SUFFIX[dtype]}")(
        recs.data_ptr(), rec_op.data_ptr(), len(recs) // REC_CHUNK - 1,
        ops.data_ptr(), fill.data_ptr(), args.data_ptr(), staged.data_ptr(),
        house_t.data_ptr(), gpool.data_ptr(), t_pad, top.data_ptr(), T,
        enc.top_slot, stream)
    _raise_on(lib, code, "stream forward")
    return top, None


def _launch_ops(lib, enc: EncodedStream, staged: torch.Tensor,
                house: torch.Tensor, out: torch.Tensor,
                out_slots: torch.Tensor) -> None:
    """One launch of the one-trial-per-thread kernel over a fresh pool:
    pool slots ``out_slots`` (int32, on the card) into the rows of
    ``out`` (``(len(out_slots), n_trials)``, or ``(n_trials,)`` for one
    slot)."""
    device, dtype = staged.device, staged.dtype
    T = staged.shape[1]
    ops, args, fill = enc.tables(device)
    pool = torch.empty((enc.pool_slots, T), dtype=dtype, device=device)
    dp = _dp_scratch(enc, -(-T // _OPS_THREADS), _OPS_THREADS, staged)
    code = getattr(lib, f"canopy_stream_ops_forward_{_SUFFIX[dtype]}")(
        ops.data_ptr(), fill.data_ptr(), args.data_ptr(), enc.n_ops,
        staged.data_ptr(), house.data_ptr(), pool.data_ptr(),
        out.data_ptr(), T, out_slots.data_ptr(), len(out_slots), _ptr(dp),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "stream forward")


def stream_roots_forward(enc: EncodedStream, staged: torch.Tensor,
                         house: torch.Tensor) -> torch.Tensor:
    """Every output slot of a multi-root program
    (:func:`compile_tree_stream` with ``roots``) on staged ``(n_basic,
    n_trials)`` input: ``(n_out, n_trials)`` of the staged dtype, row
    ``k`` root ``k``.

    ``house`` is the house vector as the kernels read it
    (:func:`house_tensor`, on the staged device and in its dtype), made
    once by the caller.  CPU tensors run
    :func:`stream_roots_forward_plain`; CUDA tensors launch the
    one-trial-per-thread kernel of ``csrc/stream.cu`` once (counted in
    ``COUNTERS["launch.stream_roots"]``) or raise.
    """
    _check_staged(enc, staged)
    device, dtype = staged.device, staged.dtype
    if house.device != device or house.dtype != dtype \
            or house.numel() != enc.n_house + 1:
        raise LogicError(f"house vector must be {enc.n_house} + 1 {dtype} "
                         f"values on {device} (house_tensor)")
    if device.type != "cuda":
        return stream_roots_forward_plain(enc, staged, house)
    lib = load_library()
    staged = staged.contiguous()
    _check_cuda(dtype, staged, house)
    out_slots = enc.outputs(device)
    out = torch.empty((len(out_slots), staged.shape[1]), dtype=dtype,
                      device=device)
    COUNTERS["launch.stream_roots"] += 1
    _launch_ops(lib, enc, staged, house, out, out_slots)
    return out


def stream_propagate_staged(enc: EncodedStream, staged: torch.Tensor,
                            house_states) -> torch.Tensor:
    """Top values ``(n_trials,)`` of an already-staged input."""
    return stream_forward(enc, staged, house_states)[0]


def stream_propagate(enc: EncodedStream, basic_p: torch.Tensor,
                     house_states) -> torch.Tensor:
    """``(n_trials, n_basic)`` -> ``(n_trials,)`` top values (stages,
    then runs; any trial count)."""
    return stream_propagate_staged(enc, stage_basic(enc, basic_p),
                                   house_states)


def stream_bdd_probability(enc: EncodedStream, values: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Exact per-trial top probability of a BDD stream program.

    ``values``: ``(n_trials, n_cols)``, the global probability matrix;
    the program's staged columns select the decision variables it reads.
    """
    return stream_propagate_staged(enc, stage_basic(enc, values, dtype),
                                   np.zeros(0, np.float32))


# ---------------------------------------------------------------------------
# Replay programs (compiler/replay.py): schedule, encoder, staging, kernel.
# ---------------------------------------------------------------------------

def _check_replay_fits(program) -> None:
    """Shared-memory check of a BUILT replay program: its pool plus its
    resident tier as built (``res_tiles`` is padded up to the basic-stream
    chunk, so it may exceed what was asked for) against what one block of
    one warp holds beside its ring and op-stream chunks."""
    slots = program.pool_slots + program.res_tiles
    if slots > REPLAY_SLOTS:
        raise LogicError(
            f"replay program needs {program.pool_slots} pool + "
            f"{program.res_tiles} resident slots; one block holds "
            f"{REPLAY_SLOTS} at 32 trials beside its ring ({SMEM_BYTES} B "
            f"of shared memory)")


def _replay_sizing(tree: CompiledTree, kwargs: dict) -> dict:
    """The card's defaults for the replay builders: no resident tier, a
    pool of ``SMEM_BYTES // (4 * REPLAY_TRIALS)`` slots (56) or the
    widest gate's working set if that is more, and no TPU VMEM budget."""
    from ..compiler.schedule import _emit_gate_ops
    kwargs = dict(kwargs)
    kwargs.setdefault("resident_tiles", 0)
    if "pool_slots" not in kwargs:
        widest = max((len(row[2]) for row in _emit_gate_ops(tree)),
                     default=0)
        kwargs["pool_slots"] = max(SMEM_BYTES // (4 * REPLAY_TRIALS),
                                   widest + 2)
    kwargs.setdefault("vmem_budget", _NO_VMEM_BUDGET)
    return kwargs


def compile_replay_stream(tree: CompiledTree, **kwargs):
    """Schedule ``tree`` as a replay program (``compiler/replay.py``,
    the shared builder) sized for the card.

    The JAX package sizes the pool from the TPU's 13 MiB of VMEM with a
    1,024-tile resident tier.  Here pool, resident tier and prefetch ring
    share one block's 232,448 B of shared memory: by default a pool of 56
    slots (``REPLAY_TRIALS``) and no resident tier; a resident tier asked
    for adds its slots, rounded up to the basic-stream chunk.  Any
    builder keyword may be given; the built program is then checked, and
    a pool plus resident tier beyond
    ``REPLAY_SLOTS`` (1,743: one warp's block beside the shallowest ring)
    raises ``LogicError``.
    """
    from ..compiler.replay import build_replay_schedule
    program = build_replay_schedule(tree, **_replay_sizing(tree, kwargs))
    _check_replay_fits(program)
    return program


@dataclasses.dataclass(kw_only=True)
class EncodedReplay(EncodedStream):
    """A replay program as one flat op table (``csrc/replay_ops.cuh``).

    ``n_basic`` counts the rows of the staged basic replay stream
    (``brs_len_pad``) and ``staged_cols`` gives each row's input column;
    ``n_log`` counts gates (the value log's rows).  Pool arguments index
    the pool (``< pool_slots``), the resident tier (``< pool_slots +
    res_rows``), then the eviction log.
    """

    res_rows: int          # resident tier: staged rows [0, res_rows)
    n_evicted: int         # eviction-log rows
    n_columns: int         # the tree's basic events (input width)
    read_rows: np.ndarray  # staged rows the program reads (the rest pad)


def encode_replay(program) -> EncodedReplay:
    """Flatten a ``ReplayProgram``'s segments into one op table (cached on
    the program).

    The encoder replays the TPU schedule's ring bookkeeping once on the
    host: a ``bwait``/``gwait`` names the chunk a ring buffer holds, an
    ``evict`` the slab position of eviction-log row ``e`` (the ``e``-th
    eviction, the row its later flush names), an ``rwait`` the row a
    refill reads.  Each read then resolves to where its value lives on
    the card: a pool slot, a resident slot, a basic-stream row, an
    eviction-log row (slab reads, refills and gate-stream reads alike) or
    a house constant.  DMA starts and waits, flushes and the segment
    boundaries' dump and load have no counterpart.  Each argument also
    records its forward value for the backward: the value-log row of the
    gate that produced it, its staged row, or its house constant.
    """
    enc = getattr(program, "_encoded", None)
    if enc is not None:
        return enc
    P, R = program.pool_slots, program.res_tiles
    log_base = P + R
    ops: list = []
    args: list = []
    value_of_slot: dict[int, int] = {}   # pool slot -> value-log row
    value_of_row: dict[int, int] = {}    # eviction-log row -> value-log row
    slab_row: dict[tuple[int, int], int] = {}
    bring: dict[int, int] = {}
    gring: dict[int, int] = {}
    read: set[int] = set()
    n_evicted = n_log = max_states = 0
    for k, seg in enumerate(program.segments):
        grs_rows = program.grs_rows[k]
        for op in seg:
            tag = op[0]
            if tag == "bwait":
                bring[op[2]] = op[1]
            elif tag == "gwait":
                gring[op[2]] = op[1]
            elif tag == "evict":
                _t, slot, sbuf, soff = op
                slab_row[(sbuf, soff)] = n_evicted
                value_of_row[n_evicted] = value_of_slot[slot]
                ops.append([EVICT, slot, 0, 0, n_evicted, 0, -1])
                n_evicted += 1
            elif tag == "rwait":
                _t, scratch_row, slot, _sem = op
                row = scratch_row - P
                value_of_slot[slot] = value_of_row[row]
                ops.append([REFILL, slot, 0, 0, row, 0, -1])
            elif tag == "gate":
                _t, kind, out_slot, locs, aux = op
                begin = len(args)
                for loc, flag in locs:
                    where = loc[0]
                    if where == "pool":
                        entry = [POOL, loc[1], LOG, value_of_slot[loc[1]]]
                    elif where == "rbas":
                        read.add(loc[1])
                        entry = [POOL, P + loc[1], STAGED, loc[1]]
                    elif where == "brs":
                        row = bring[loc[1]] * program.brs_chunk + loc[2]
                        read.add(row)
                        entry = [STAGED, row, STAGED, row]
                    elif where == "house":
                        entry = [HOUSE, loc[1], HOUSE, loc[1]]
                    else:
                        if where == "grs":
                            pos = gring[loc[1]] * program.grs_chunk + loc[2]
                            row = int(grs_rows[pos]) - P
                        else:   # slab
                            row = slab_row[(loc[1], loc[2])]
                        entry = [POOL, log_base + row, LOG,
                                 value_of_row[row]]
                    args.append(entry[:2] + [int(bool(flag))] + entry[2:])
                if kind == "count":
                    aux0, aux1, states = _count_row(aux, len(locs), args,
                                                    begin)
                    max_states = max(max_states, states)
                elif kind in ("prod", "pair"):
                    aux0, aux1 = int(bool(aux)), 0
                else:
                    raise LogicError(f"replay programs hold no {kind} op")
                ops.append([_KIND[kind], out_slot, begin, len(args), aux0,
                            aux1, n_log])
                value_of_slot[out_slot] = n_log
                n_log += 1
    if n_evicted != program.n_evicted:
        raise LogicError(f"replay program evicts {program.n_evicted} "
                         f"values, its ops {n_evicted}")
    enc = EncodedReplay(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.zeros(len(ops), dtype=np.float32), n_log=n_log,
        n_basic=program.brs_len_pad, n_house=program.n_house,
        pool_slots=max(P, 1), top_slot=program.top_slot,
        max_count_states=max_states,
        staged_cols=np.asarray(program.brs_cols, dtype=np.int64),
        out_slots=np.asarray([program.top_slot], dtype=np.int32),
        res_rows=R, n_evicted=n_evicted, n_columns=program.n_basic,
        read_rows=np.array(sorted(read), dtype=np.int64))
    program._encoded = enc
    return enc


def _stage_rows(enc: EncodedReplay, basic_p: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    cols = torch.from_numpy(enc.staged_cols).to(basic_p.device)
    return basic_p.to(dtype).T.contiguous().index_select(0, cols)


def _grad_plan(enc: EncodedReplay):
    """The read rows grouped by occurrence: step ``k`` pairs each column's
    ``k``-th read row (in stream order) with that column, so no step
    names a column twice."""
    if "grad_plan" not in enc._cache:
        rows = enc.read_rows
        cols = enc.staged_cols[rows]
        order = np.argsort(cols, kind="stable")
        sorted_cols = cols[order]
        starts = np.flatnonzero(np.r_[True, sorted_cols[1:]
                                      != sorted_cols[:-1]])
        rank = np.arange(len(order)) - np.repeat(
            starts, np.diff(np.r_[starts, len(order)]))
        steps = []
        for k in range(int(rank.max()) + 1 if len(rank) else 0):
            pick = order[rank == k]
            steps.append((rows[pick], cols[pick]))
        enc._cache["grad_plan"] = steps
    return enc._cache["grad_plan"]


def replay_grad_basic(enc: EncodedReplay, g_brs: torch.Tensor
                      ) -> torch.Tensor:
    """A basic-stream cotangent ``(brs_len_pad, n_trials)`` summed back to
    ``(n_trials, n_columns)``: the adjoint of :func:`stage_replay`.

    A segment-sum by column in a fixed order (each column's reads in
    stream order, one step per occurrence, no column twice in a step), so
    the result is the same on every device and run; columns the program
    never reads stay zero.
    """
    out = g_brs.new_zeros((enc.n_columns, g_brs.shape[1]))
    for rows, cols in _grad_plan(enc):
        out.index_add_(0, torch.from_numpy(cols).to(g_brs.device),
                       g_brs[torch.from_numpy(rows).to(g_brs.device)])
    return out.T


class _StageReplay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, basic_p, enc, dtype):
        ctx.enc, ctx.in_dtype = enc, basic_p.dtype
        return _stage_rows(enc, basic_p, dtype)

    @staticmethod
    def backward(ctx, g):
        return replay_grad_basic(ctx.enc, g).to(ctx.in_dtype), None, None


def stage_replay(enc: EncodedReplay, basic_p: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(n_trials, n_columns)`` -> the basic replay stream
    ``(brs_len_pad, n_trials)`` of ``dtype``: one row per basic read in
    execution order (the resident tier its prefix), trials contiguous,
    the transpose of the TPU's tile-major layout; any trial count.

    Stage once per batch (the stream is ``brs_len_pad`` rows, several
    times the input).  Under autograd the gradient flows back through
    :func:`replay_grad_basic`.
    """
    if basic_p.ndim != 2 or basic_p.shape[1] != enc.n_columns:
        raise LogicError(f"replay staging takes (n_trials, "
                         f"{enc.n_columns}), got {tuple(basic_p.shape)}")
    if torch.is_grad_enabled() and basic_p.requires_grad:
        return _StageReplay.apply(basic_p, enc, dtype)
    return _stage_rows(enc, basic_p, dtype)


def unstage_replay(enc: EncodedReplay, brs: torch.Tensor) -> torch.Tensor:
    """``(n_trials, n_columns)`` from a staged replay stream: each basic's
    first read row (all its rows carry the same value); basics the
    program never reads come back zero (they cannot reach the top)."""
    rows = enc.read_rows
    cols, first = np.unique(enc.staged_cols[rows], return_index=True)
    out = brs.new_zeros((brs.shape[1], enc.n_columns))
    out[:, torch.from_numpy(cols).to(brs.device)] = \
        brs[torch.from_numpy(rows[first]).to(brs.device)].T
    return out


def replay_forward_plain(enc: EncodedReplay, staged: torch.Tensor,
                         house: torch.Tensor, with_log: bool = False):
    """The replay kernel's arithmetic in plain torch (any dtype, any
    device, differentiable by autograd), in the kernel's op order.
    Returns ``(top, value log or None)``."""
    ops, args, _fill = enc.plain_ops()
    T = staged.shape[1]
    shared_rows = enc.pool_slots + enc.res_rows
    shared: list = [None] * enc.pool_slots + \
        [staged[i] for i in range(enc.res_rows)]
    evlog: list = [None] * enc.n_evicted
    vlog: list = [None] * enc.n_log if with_log else None

    def load(a):
        src, idx, flag = a[0], a[1], a[2]
        if src == POOL:
            v = shared[idx] if idx < shared_rows else \
                evlog[idx - shared_rows]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if flag else v

    for op in ops:
        kind, slot = op[0], op[1]
        if kind == EVICT:
            evlog[op[4]] = shared[slot]
        elif kind == REFILL:
            shared[slot] = evlog[op[4]]
        else:
            v = _plain_value(op, 0.0, args, load, staged)
            shared[slot] = v
            if with_log:
                vlog[op[6]] = v
    return shared[enc.top_slot], (torch.stack(vlog) if with_log else None)


# The replay forward's op stream (csrc/replay_ops.cuh): word kinds in
# bits 30-31 of an argument word, the complement flag in bit 29, the
# payload below; a fetch code names the row a ring entry copies (0: none,
# 1 + r: basic-stream row r, _RING_EVLOG + r: eviction-log row r).
_W_SHARED, _W_RING, _W_HOUSE = 0, 1, 2
_PAYLOAD = (1 << 29) - 1
_RING_EVLOG = 1 << 28
_HEADER_WORDS = 8
_END = -1


@dataclasses.dataclass(frozen=True)
class ReplayPlan:
    """The replay forward's launch shape for one program, value type and
    trial count (:func:`replay_plan`)."""

    width: int          # trials (threads) per block
    depth: int          # ring rows per thread
    chunk_words: int    # int32 words per op-stream chunk
    shared_bytes: int   # dynamic shared memory per block


def _ring_rows(enc: EncodedStream) -> tuple[int, int]:
    """``(shared rows, eviction-log rows)`` of a program the ring kernel
    runs: a replay program's pool and resident tier and its eviction log;
    a spill program's pool and its scratch rows (its SPILL ops and staged
    refills read the staged input as replay reads the basic stream)."""
    if isinstance(enc, EncodedReplay):
        return enc.pool_slots + enc.res_rows, enc.n_evicted
    return enc.pool_slots, enc.n_scratch


def _chunk_words(enc: EncodedStream) -> int:
    """Op-stream chunk words: ``REPLAY_CHUNK_WORDS``, or the power of two
    that holds the longest op (header, arguments or ring pads, and the
    end mark)."""
    longest = int((enc.ops[:, 3] - enc.ops[:, 2]).max(initial=0))
    need = _HEADER_WORDS + max(longest, REPLAY_RING_DEPTHS[-1]) + 1
    words = REPLAY_CHUNK_WORDS
    while words < need:
        words *= 2
    return words


def replay_plan(enc: EncodedStream, dtype: torch.dtype,
                n_trials: int) -> ReplayPlan:
    """Block width and ring depth of the ring kernel, from the program's
    shared rows: a replay program's ``pool_slots + res_rows``, a spill
    program's ``pool_slots``.

    A block of ``width`` trials holds ``(pool_slots + res_rows + depth) *
    width`` values and two op-stream chunks in shared memory.  The ring
    depth for a width is the smallest of ``REPLAY_RING_DEPTHS`` whose rows
    hold ``REPLAY_RING_BYTES`` (the deepest if none does, or the deepest
    that fits); the width is the widest power of two up to 1,024 that
    fits with its depth and leaves no SM idle (at most ``n_trials / 132``
    rounded down to a power of two, 32 at least: below a warp only where
    a warp does not fit).  Raises ``LogicError`` when even one trial per
    block does not fit.
    """
    size = torch.finfo(dtype).bits // 8
    slots = _ring_rows(enc)[0]
    chunk = _chunk_words(enc)

    def shared(width: int, depth: int) -> int:
        return _REPLAY_BARRIER_BYTES + 8 * chunk + (slots + depth) * width \
            * size

    def depth_for(width: int) -> int:
        return next((d for d in REPLAY_RING_DEPTHS
                     if d * width * size >= REPLAY_RING_BYTES),
                    REPLAY_RING_DEPTHS[-1])

    spread = max(32, 1 << (-(-n_trials // _SMS)).bit_length() - 1)
    width = 1024
    while width > 1 and (width > spread or
                         shared(width, depth_for(width)) > SMEM_BYTES):
        width //= 2
    depths = [d for d in REPLAY_RING_DEPTHS if d <= depth_for(width)
              and shared(width, d) <= SMEM_BYTES]
    if not depths:
        raise LogicError(f"{slots} pool slots of {dtype} and the "
                         f"shallowest ring exceed one block's {SMEM_BYTES} "
                         f"B of shared memory")
    return ReplayPlan(width, depths[-1], chunk, shared(width, depths[-1]))


@dataclasses.dataclass
class RingStream:
    """A replay or spill program as the ring kernel's op stream
    (:func:`replay_ring_stream`)."""

    words: np.ndarray   # (n_chunks * chunk_words,) int32
    head: np.ndarray    # (depth - 1,) int32: the ring's first fetch codes
    n_chunks: int
    chunk_words: int
    depth: int
    fetches: np.ndarray  # fetch code of every ring consumption, in order
    n_pads: int          # of them, pads consumed at EVICT ops
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def tables(self, device: torch.device):
        """(words, head) on ``device`` (cached)."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = (torch.from_numpy(self.words).to(device),
                                torch.from_numpy(self.head).to(device))
        return self._cache[key]


def _ring_fetches(enc: EncodedStream, depth: int):
    """The fetch codes of every ring consumption in program order, and
    the pads each op consumes.

    Each staged argument (a basic-stream row of a replay program, a staged
    row of a spill program, a SPILL op's one argument), eviction-log
    argument and REFILL consumes the next ring entry; the kernel issues
    entry ``k + depth - 1`` when it consumes entry ``k``.  An eviction-log
    entry must be issued after the EVICT that stores the value it reads,
    so where the program reads a row back sooner than that, pad entries
    (fetching nothing) are consumed at the EVICT, after its store, until
    the read's issue falls at or after them.  A row stored twice (a
    scratch row a spill schedule reuses) is read from its latest EVICT
    before the read: the fetch is issued after that store and, being
    consumed by the read, completes before the next store to the row.
    """
    shared_rows = _ring_rows(enc)[0]
    codes: list = []
    evict_op: dict[int, int] = {}   # log row -> its latest EVICT so far
    reads: list = []            # (op, position in its op, that EVICT)
    args = enc.args.tolist()

    def stored(row: int) -> int:
        if row not in evict_op:
            raise LogicError(f"op reads eviction-log row {row} before any "
                             f"EVICT stores it")
        return evict_op[row]

    for o, (kind, _slot, b, e, aux0, _a1, _row) in enumerate(
            enc.ops.tolist()):
        if kind == EVICT:
            evict_op[aux0] = o
            codes.append([])
            continue
        if kind == REFILL:
            reads.append((o, 0, stored(aux0)))
            codes.append([_RING_EVLOG + aux0])
            continue
        op_codes = []
        for src, idx, *_rest in args[b:e]:
            if src == STAGED:
                op_codes.append(idx + 1)
            elif src == POOL and idx >= shared_rows:
                reads.append((o, len(op_codes), stored(idx - shared_rows)))
                op_codes.append(_RING_EVLOG + idx - shared_rows)
        codes.append(op_codes)
    counts = np.array([len(c) for c in codes], dtype=np.int64)
    pads = np.zeros(len(codes), dtype=np.int64)
    if reads:
        r_op, r_pos, r_evict = (np.array(c) for c in zip(*reads))
        while True:
            first = np.cumsum(counts + pads) - counts - pads
            need = first[r_evict] + depth - 1 - (first[r_op] + r_pos)
            late = np.flatnonzero(need > 0)
            if not len(late):
                break
            pads[r_evict[late[0]]] += need[late[0]]
    return codes, pads


def replay_ring_stream(enc: EncodedStream, depth: int) -> RingStream:
    """The replay or spill program ``enc`` as the ring kernel's op
    stream for a ring of ``depth`` rows (cached on ``enc``).

    Ops keep their order, in chunks of ``_chunk_words(enc)`` int32 words
    that hold whole ops (an end mark, -1, after the last).  An op is an
    8-word header ``[kind, slot, b, e, aux0, aux1, log_row, extra]``
    (``b``, ``e``: its argument words within the chunk) and its argument
    words.  A shared-memory argument (pool or resident slot) or house
    argument names its index; a basic-stream or eviction-log argument is
    a ring read whose payload is the fetch code the kernel issues when it
    consumes it (the entry ``depth - 1`` ahead).  ``extra``: a gate's
    count of ring reads, a REFILL's fetch code to issue; an EVICT's words
    are its pads, each a fetch code to issue.  A SPILL op is a
    one-argument op: its staged row is one ring read.
    """
    key = f"ring:{depth}"
    if key in enc._cache:
        return enc._cache[key]
    codes, pads = _ring_fetches(enc, depth)
    seq = []
    for o, op_codes in enumerate(codes):
        seq += [0] * int(pads[o]) + op_codes
    fetches = np.asarray(seq, dtype=np.int64)
    shared_rows, log_rows = _ring_rows(enc)
    if len(fetches) and (fetches.max() >= _PAYLOAD or max(
            enc.n_basic, log_rows) >= _RING_EVLOG):
        raise LogicError("program too large for the ring's 28-bit row "
                         "codes")
    ahead = np.concatenate([fetches, np.zeros(depth, np.int64)])
    chunk = _chunk_words(enc)
    words: list = []
    pos = 0
    k = depth - 1        # the fetch issued by the next consumption
    args = enc.args.tolist()
    for o, (kind, slot, b, e, aux0, aux1, row) in enumerate(
            enc.ops.tolist()):
        body: list = []
        if kind == EVICT:
            body = [(_W_RING << 30) | int(c)
                    for c in ahead[k:k + int(pads[o])]]
            k += int(pads[o])
            extra = 0
        elif kind == REFILL:
            extra = int(ahead[k])
            k += 1
        else:
            for src, idx, flag, *_rest in args[b:e]:
                if src == STAGED or (src == POOL and idx >= shared_rows):
                    word = (_W_RING << 30) | int(ahead[k])
                    k += 1
                elif src == POOL:
                    word = (_W_SHARED << 30) | idx
                else:
                    word = (_W_HOUSE << 30) | idx
                body.append(word | (flag << 29))
            extra = len(codes[o])
        if pos + _HEADER_WORDS + len(body) + 1 > chunk:
            words += [_END] + [0] * (chunk - pos - 1)
            pos = 0
        begin = pos + _HEADER_WORDS
        words += [kind, slot, begin, begin + len(body), aux0, aux1, row,
                  extra] + body
        pos = begin + len(body)
    words += [_END] + [0] * (chunk - pos - 1)
    stream = RingStream(
        words=np.asarray(words, dtype=np.int64).astype(np.int32),
        head=ahead[:depth - 1].astype(np.int32), n_chunks=len(words) // chunk,
        chunk_words=chunk, depth=depth, fetches=fetches,
        n_pads=int(pads.sum()))
    enc._cache[key] = stream
    return stream


def replay_forward(enc: EncodedReplay, staged: torch.Tensor, house,
                   with_log: bool = False):
    """Run a replay program on its staged stream ``(brs_len_pad,
    n_trials)``.

    Returns ``(top (n_trials,), value log (n_log, n_trials) or None)``.
    CPU tensors run :func:`replay_forward_plain`; CUDA tensors launch
    ``csrc/replay.cu`` (with the log, ``csrc/replay_adjoint.cu``'s taped
    forward) on :func:`replay_ring_stream` in the :func:`replay_plan`
    shape, or raise.
    """
    _check_staged(enc, staged)
    device, dtype = staged.device, staged.dtype
    house_t = house_tensor(enc, house, device, dtype)
    if device.type != "cuda":
        return replay_forward_plain(enc, staged, house_t, with_log)
    T = staged.shape[1]
    vlog = torch.empty((enc.n_log, T), dtype=dtype, device=device) \
        if with_log else None
    name = "replay_tape_forward" if with_log else "replay_forward"
    top = _ring_launch(enc, staged, house_t, name,
                       "replay_tape" if with_log else "replay",
                       (_ptr(vlog),), (enc.pool_slots, enc.res_rows))
    return top, vlog


def _ring_launch(enc: EncodedStream, staged: torch.Tensor,
                 house_t: torch.Tensor, entry: str, launch_key: str,
                 after_log: tuple, slots: tuple) -> torch.Tensor:
    """Launch the ring kernel entry ``canopy_{entry}_{f32|f64}`` on the
    CUDA tensor ``staged`` in the :func:`replay_plan` shape (which raises
    before any launch when the program does not fit a block): its
    arguments after the eviction log (or scratch) are ``after_log``, its
    pool arguments ``slots``.  Returns the top ``(n_trials,)``."""
    lib = load_library()
    device, dtype = staged.device, staged.dtype
    staged = staged.contiguous()
    _check_cuda(dtype, staged)
    T = staged.shape[1]
    plan = replay_plan(enc, dtype, T)
    ring = replay_ring_stream(enc, plan.depth)
    words, head = ring.tables(device)
    evlog = torch.empty((max(_ring_rows(enc)[1], 1), T), dtype=dtype,
                        device=device)
    top = torch.empty(T, dtype=dtype, device=device)
    dp = _dp_scratch(enc, -(-T // plan.width), plan.width, staged)
    COUNTERS["launch." + launch_key] += 1
    code = getattr(lib, f"canopy_{entry}_{_SUFFIX[dtype]}")(
        words.data_ptr(), ring.n_chunks, ring.chunk_words, head.data_ptr(),
        staged.data_ptr(), house_t.data_ptr(), evlog.data_ptr(), *after_log,
        top.data_ptr(), T, *slots, enc.top_slot, plan.width, plan.depth,
        _ptr(dp), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, entry.replace("_", " "))
    return top


def replay_propagate_staged(enc: EncodedReplay, staged: torch.Tensor,
                            house_states) -> torch.Tensor:
    """Top values ``(n_trials,)`` of an already-staged replay stream."""
    return replay_forward(enc, staged, house_states)[0]


def replay_propagate(enc: EncodedReplay, basic_p: torch.Tensor,
                     house_states) -> torch.Tensor:
    """``(n_trials, n_columns)`` -> ``(n_trials,)`` top values (stages,
    then runs; hot loops stage once and call
    :func:`replay_propagate_staged`)."""
    return replay_propagate_staged(enc, stage_replay(enc, basic_p),
                                   house_states)


# ---------------------------------------------------------------------------
# Spill programs (compiler/spill.py): schedule, encoder, kernel.
# ---------------------------------------------------------------------------

def _check_spill_fits(pool_slots: int) -> None:
    """A spill block holds its pool in shared memory beside the ring
    kernel's prefetch ring and op-stream chunks: at most ``SPILL_SLOTS``
    slots (one warp of float32 trials, :func:`replay_plan`)."""
    if pool_slots > SPILL_SLOTS:
        raise LogicError(
            f"spill program needs {pool_slots} pool slots; one block holds "
            f"{SPILL_SLOTS} at 32 trials beside its ring ({SMEM_BYTES} B "
            f"of shared memory)")


def compile_spill_stream(tree: CompiledTree, **kwargs):
    """Schedule ``tree`` as a spill program (``compiler/spill.py``, the
    shared Belady builder) sized for the card.

    The JAX package sizes the pool from the TPU's 13 MiB of VMEM (minus a
    staging ring of chunks and two slab buffers).  Here the pool is what
    one block of the ring kernel keeps in shared memory: by default
    ``SMEM_BYTES // (4 * SPILL_TRIALS)`` slots (56), or the widest gate's
    working set if that is more; every basic event sits in one staging
    chunk (the card fetches any staged row from device memory, so no
    basic needs a pool slot); and no TPU VMEM budget.  Any builder keyword
    may be given.  The built program's pool is checked: beyond
    ``SPILL_SLOTS`` (1,743) it raises ``LogicError``, as does a gate
    wider than an explicitly given pool (the builder's own check).
    """
    from ..compiler.schedule import _emit_gate_ops
    from ..compiler.spill import build_spill_schedule
    kwargs = dict(kwargs)
    if "pool_slots" not in kwargs:
        widest = max((len(row[2]) for row in _emit_gate_ops(tree)),
                     default=0)
        kwargs["pool_slots"] = max(SMEM_BYTES // (4 * SPILL_TRIALS),
                                   widest + 2)
    kwargs.setdefault("chunk_tiles", max(tree.n_basic, 1))
    kwargs.setdefault("vmem_budget", _NO_VMEM_BUDGET)
    program = build_spill_schedule(tree, **kwargs)
    _check_spill_fits(program.pool_slots)
    return program


@dataclasses.dataclass(kw_only=True)
class EncodedSpill(EncodedStream):
    """A spill program as one flat op table (``csrc/spill.cu``).

    Pool arguments index the shared-memory pool; EVICT and REFILL ops
    move a slot to or from a scratch row in device memory (``aux0``; a
    row may be stored more than once); SPILL ops copy a staged row into a
    slot (the TPU's staging-buffer spills and its refills from the staged
    array).  ``n_log`` counts gates; ``counts`` the ops of each kind the
    TPU schedule had.
    """

    n_scratch: int         # scratch rows (evicted values)
    counts: dict


def _spill_staged_row(buf_chunk: dict, buf: int, off: int, ct: int,
                      n_basic: int) -> int:
    if buf not in buf_chunk:
        raise LogicError(f"spill program reads staging buffer {buf} before "
                         f"a chunk lands in it")
    row = buf_chunk[buf] * ct + off
    if row >= n_basic:
        raise LogicError(f"spill program reads staging pad row {row}")
    return row


def encode_spill(program) -> EncodedSpill:
    """Flatten a ``SpillProgram``'s segments into one op table (cached on
    the program; either package's program).

    The encoder replays the TPU schedule's DMA bookkeeping once on the
    host: a chunk ``wait`` names the chunk a staging buffer holds, so a
    ``stage[buf, off]`` read becomes a staged-row read and a ``spill`` a
    SPILL op; an ``evict`` into slab position ``(buf, off)`` becomes one
    EVICT op storing the slot to the scratch row that the later flush
    (``efstart``) of that position names; an ``rwait`` becomes a REFILL
    from that scratch row, or a SPILL from the staged row.  Chunk starts,
    refill starts, flush waits and the segment boundaries' dump and load
    (``dstart`` ... ``lwait``) have no counterpart: the pool stays in
    shared memory through every segment, and a refill of the boundary
    dump region (scratch rows below ``pool_slots``) raises.
    """
    enc = getattr(program, "_encoded", None)
    if enc is not None:
        return enc
    P, ct, n_b = program.pool_slots, program.chunk_tiles, program.n_basic
    ops: list = []
    args: list = []
    slab: dict[tuple[int, int], int] = {}   # slab position -> EVICT op
    counts = dict(spills=0, evictions=0, staged_refills=0,
                  scratch_refills=0, segments=len(program.segments))
    n_scratch = n_log = max_states = 0

    def copy_staged(slot: int, row: int) -> None:
        ops.append([SPILL, slot, len(args), len(args) + 1, 0, 0, -1])
        args.append([STAGED, row, 0, STAGED, row])

    for seg in program.segments:
        buf_chunk: dict[int, int] = {}
        for op in seg:
            tag = op[0]
            if tag == "wait":
                buf_chunk[op[2]] = op[1]
            elif tag == "spill":
                _t, buf, off, slot = op
                copy_staged(slot, _spill_staged_row(buf_chunk, buf, off, ct,
                                                    n_b))
                counts["spills"] += 1
            elif tag == "evict":
                _t, slot, sbuf, soff = op
                slab[(sbuf, soff)] = len(ops)
                ops.append([EVICT, slot, 0, 0, -1, 0, -1])
                counts["evictions"] += 1
            elif tag == "efstart":
                _t, sbuf, off0, n, row0, _sem = op
                for i in range(n):
                    row = row0 + i - P
                    if (sbuf, off0 + i) not in slab or row < 0:
                        raise LogicError(f"spill flush of slab ({sbuf}, "
                                         f"{off0 + i}) names no eviction")
                    ops[slab.pop((sbuf, off0 + i))][4] = row
                    n_scratch = max(n_scratch, row + 1)
            elif tag == "rwait":
                _t, src, row, slot, _sem = op
                if src == 0:
                    if row >= n_b:
                        raise LogicError(f"spill refill of staging pad row "
                                         f"{row}")
                    copy_staged(slot, row)
                    counts["staged_refills"] += 1
                else:
                    if row < P:
                        raise LogicError(f"spill refill reads scratch row "
                                         f"{row} of the boundary dump region")
                    ops.append([REFILL, slot, 0, 0, row - P, 0, -1])
                    counts["scratch_refills"] += 1
            elif tag == "gate":
                _t, kind, out_slot, locs, aux = op
                begin = len(args)
                for loc, flag in locs:
                    if loc[0] == "stage":
                        row = _spill_staged_row(buf_chunk, loc[1], loc[2], ct,
                                                n_b)
                        entry = [STAGED, row, STAGED, row]
                    elif loc[0] == "house":
                        entry = [HOUSE, loc[1], HOUSE, loc[1]]
                    else:
                        entry = [POOL, loc[1], POOL, loc[1]]
                    args.append(entry[:2] + [int(bool(flag))] + entry[2:])
                if kind == "count":
                    aux0, aux1, states = _count_row(aux, len(locs), args,
                                                    begin)
                    max_states = max(max_states, states)
                elif kind in ("prod", "pair"):
                    aux0, aux1 = int(bool(aux)), 0
                else:
                    raise LogicError(f"spill programs hold no {kind} op")
                ops.append([_KIND[kind], out_slot, begin, len(args), aux0,
                            aux1, n_log])
                n_log += 1
            # start, rstart, efwait, dstart, dwait, lstart, lwait: the
            # TPU's DMA issue and completion, nothing to do on the card.
    if slab:
        raise LogicError(f"{len(slab)} spill evictions are never flushed")
    if counts["evictions"] != program.n_evicted:
        raise LogicError(f"spill program evicts {program.n_evicted} values, "
                         f"its ops {counts['evictions']}")
    enc = EncodedSpill(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.zeros(len(ops), dtype=np.float32), n_log=n_log,
        n_basic=n_b, n_house=program.n_house, pool_slots=max(P, 1),
        top_slot=program.top_slot, max_count_states=max_states,
        staged_cols=np.asarray(program.basic_perm, dtype=np.int64),
        out_slots=np.asarray([program.top_slot], dtype=np.int32),
        n_scratch=n_scratch, counts=counts)
    program._encoded = enc
    return enc


def spill_forward_plain(enc: EncodedSpill, staged: torch.Tensor,
                        house: torch.Tensor) -> torch.Tensor:
    """The spill kernel's arithmetic in plain torch (any dtype, any
    device), in the kernel's op order; returns the top ``(n_trials,)``."""
    ops, args, _fill = enc.plain_ops()
    T = staged.shape[1]
    pool: list = [None] * enc.pool_slots
    scratch: list = [None] * enc.n_scratch

    def load(a):
        src, idx, flag = a[0], a[1], a[2]
        if src == POOL:
            v = pool[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if flag else v

    for op in ops:
        kind, slot = op[0], op[1]
        if kind == EVICT:
            scratch[op[4]] = pool[slot]
        elif kind == REFILL:
            pool[slot] = scratch[op[4]]
        else:
            pool[slot] = _plain_value(op, 0.0, args, load, staged)
    return pool[enc.top_slot]


def spill_forward(enc: EncodedSpill, staged: torch.Tensor,
                  house) -> torch.Tensor:
    """Run a spill program on staged ``(n_basic, n_trials)`` input;
    returns the top ``(n_trials,)``.  CPU tensors run
    :func:`spill_forward_plain`; CUDA tensors launch ``csrc/spill.cu`` on
    :func:`replay_ring_stream` in the :func:`replay_plan` shape, or raise
    (a pool beyond one block's shared memory raises before any
    launch)."""
    _check_staged(enc, staged)
    device, dtype = staged.device, staged.dtype
    house_t = house_tensor(enc, house, device, dtype)
    if device.type != "cuda":
        return spill_forward_plain(enc, staged, house_t)
    _check_spill_fits(enc.pool_slots)
    return _ring_launch(enc, staged, house_t, "spill_forward", "spill", (),
                        (enc.pool_slots,))


def spill_propagate_staged(enc: EncodedSpill, staged: torch.Tensor,
                           house_states) -> torch.Tensor:
    """Top values ``(n_trials,)`` of an already-staged input."""
    return spill_forward(enc, staged, house_states)


def spill_propagate(enc: EncodedSpill, basic_p: torch.Tensor,
                    house_states) -> torch.Tensor:
    """``(n_trials, n_basic)`` -> ``(n_trials,)`` top values (stages,
    then runs; hot loops stage once with :func:`stage_basic` and call
    :func:`spill_propagate_staged`)."""
    return spill_propagate_staged(enc, stage_basic(enc, basic_p),
                                  house_states)
