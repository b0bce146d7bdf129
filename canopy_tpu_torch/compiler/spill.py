"""HBM spill tier for the streaming engine: Belady-scheduled VMEM pool.

The plain stream schedule (``compiler/schedule.py``) rejects trees whose
live set exceeds the VMEM pool — on a v5e that is ~2.5k (8, 128) tiles,
which uniform-random trees blow past around 30k cone gates.  This module
removes that wall with a *spill tier*: the pool becomes a cache over an
HBM scratch array, scheduled entirely at compile time.

* **Eviction is optimal (Belady)**: the op list is static, so at every
  allocation the victim is the resident value with the furthest next
  use — computed exactly, not estimated.
* **Eviction writes are coalesced**: evicted tiles append to a VMEM
  slab (a VPU copy each) that flushes to HBM in slab-sized async DMAs,
  so the write side streams at full bandwidth.  Values are immutable,
  so a re-evicted value whose HBM copy already exists costs nothing.
* **Refills are prefetched singles**: each refill is one (8, 128)-tile
  async DMA hoisted a configurable distance ahead of its consumer and
  tracked by a rotating semaphore pool; basics refill straight from the
  staged input array (their HBM home), so they are never written back.
* **Big cones are segmented**: the straight-line kernel's unrolled-op
  count is capped per segment; at a boundary the whole pool dumps to a
  reserved scratch region with one contiguous DMA and the next
  segment's kernel reloads it, so a 1M-gate tree compiles as a chain of
  bounded Mosaic programs sharing one scratch array.

The output is a :class:`SpillProgram` — per-segment straight-line op
lists in the grammar of ``ops/stream_kernel.py`` plus the spill ops —
executed by ``ops/stream_kernel.spill_propagate_staged``.  A host-side
reference interpreter (:func:`simulate_spill_program`) executes the same
grammar with hazard checking, so schedules validate on CPU without a
TPU or interpret-mode Pallas.

Reference anchor: this is the quantification engine the reference
specifies but never built (``settings.h:13-22``, the absent
``src/bool/bool`` — SURVEY.md §2.6) at the scale of its config-3
synthetic (1M gates, BASELINE.md), scheduled for the TPU memory
hierarchy: VMEM as a compiler-managed cache over HBM.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..errors import LogicError
from .graph import CompiledTree
from .schedule import _TILE_BYTES, _VMEM_BUDGET, _dfs_exec_rows, _emit_gate_ops

__all__ = ["SpillProgram", "build_spill_schedule", "simulate_spill_program"]

_INF = 1 << 60


@dataclasses.dataclass
class SpillProgram:
    """A segmented streaming program with an HBM spill tier.

    ``segments[k]`` is a straight-line op list sharing the grammar of
    :class:`~canopy_tpu.compiler.schedule.StreamProgram` (``start`` /
    ``wait`` / ``spill`` / ``gate``) plus:

    - ``("evict", pool_slot, slab_buf, slab_off)`` — VPU copy of a pool
      tile into the eviction slab.
    - ``("efstart"/"efwait", slab_buf, off0, n, row0, sem)`` — flush a
      contiguous slab range to scratch rows ``[row0, row0+n)``.
    - ``("rstart"/"rwait", src, row, pool_slot, sem)`` — refill one tile
      into the pool; ``src`` 0 = the staged basic array (``row`` is the
      staging position), 1 = the scratch array.
    - ``("dstart"/"dwait")`` / ``("lstart"/"lwait")`` — dump/load the
      whole pool to/from scratch rows ``[0, pool_slots)`` at segment
      boundaries.

    Scratch rows are per trial-tile: the backing array holds
    ``n_tiles * scratch_rows`` tiles, rows ``[0, pool_slots)`` reserved
    for boundary dumps and the rest assigned to evicted values in
    first-eviction order (so flushes are contiguous appends).
    """

    segments: list
    basic_perm: np.ndarray
    n_basic: int
    n_basic_pad: int
    chunk_tiles: int
    n_chunks: int
    n_bufs: int
    pool_slots: int
    slab_tiles: int
    n_flush_sems: int
    n_refill_sems: int
    scratch_rows: int
    top_slot: int
    nnz: int
    n_ops: int
    n_house: int
    n_evicted: int
    n_refills: int
    stage_cols: np.ndarray | None = None

    @property
    def vmem_bytes(self) -> int:
        bufs = min(self.n_chunks, self.n_bufs)
        return (bufs * self.chunk_tiles + self.pool_slots
                + 2 * self.slab_tiles) * _TILE_BYTES


def build_spill_schedule(tree: CompiledTree, chunk_tiles: int = 256,
                         n_bufs: int = 3, slab_tiles: int = 128,
                         max_ops_per_segment: int = 16384,
                         pool_slots: int | None = None,
                         hoist_events: int = 64,
                         n_refill_sems: int = 16,
                         n_flush_sems: int = 4,
                         vmem_budget: int = _VMEM_BUDGET) -> SpillProgram:
    """Compile ``tree`` into a :class:`SpillProgram`.

    Raises :class:`LogicError` only for structurally impossible inputs
    (no basics, a single gate's fan-in wider than the pool) — unlike the
    plain stream schedule there is no live-set ceiling.
    """
    if tree.top_index is None:
        raise LogicError("spill schedule needs an anchored top event")
    return _build_spill(_emit_gate_ops(tree), tree.n_basic, tree.n_house,
                        tree.top_index, chunk_tiles, n_bufs, slab_tiles,
                        max_ops_per_segment, pool_slots, hoist_events,
                        n_refill_sems, n_flush_sems, vmem_budget)


def _build_spill(gate_rows, n_basic, n_house, top_index, chunk_tiles,
                 n_bufs, slab_tiles, max_ops_per_segment, pool_slots,
                 hoist_events, n_refill_sems, n_flush_sems,
                 vmem_budget) -> SpillProgram:
    if n_basic == 0:
        raise LogicError("spill schedule needs at least one basic event")
    n_b, n_h = n_basic, n_house
    exec_rows = _dfs_exec_rows(gate_rows, n_b, n_h, top_index)
    n_ops = len(exec_rows)
    nnz = sum(len(row[2]) for row in exec_rows)

    # Staged-input layout: global first-use order, like the plain
    # stream schedule (each segment re-reads the chunks it needs).
    first_use: dict[int, int] = {}
    for g, row in enumerate(exec_rows):
        for arg, _flag in row[2]:
            if arg < n_b:
                first_use.setdefault(arg, g)
    basic_perm = np.fromiter(
        sorted(first_use, key=first_use.__getitem__), dtype=np.int64,
        count=len(first_use))
    if len(basic_perm) < n_b:
        rest = np.setdiff1d(np.arange(n_b), basic_perm)
        basic_perm = np.concatenate([basic_perm, rest])
    n_chunks_layout = -(-n_b // chunk_tiles)
    n_basic_pad = n_chunks_layout * chunk_tiles
    stage_pos = {int(s): p for p, s in enumerate(basic_perm)}
    chunk_of = {s: stage_pos[s] // chunk_tiles for s in stage_pos}

    # Pool size from the VMEM budget (staging ring + 2 slab buffers).
    staging_tiles = min(n_chunks_layout, n_bufs) * chunk_tiles
    budget_tiles = vmem_budget // _TILE_BYTES
    if pool_slots is None:
        pool_slots = budget_tiles - staging_tiles - 2 * slab_tiles
    max_fanin = max((len(row[2]) for row in exec_rows), default=0)
    if pool_slots < max_fanin + 2:
        raise LogicError(
            f"spill schedule: pool of {pool_slots} tiles cannot hold a "
            f"fan-in-{max_fanin} gate's working set")
    P = pool_slots

    # Segment boundaries: fixed op-count cuts (the pool dumps/reloads
    # wholesale across them, so any cut point is valid).
    segments_rng = [(a, min(a + max_ops_per_segment, n_ops))
                    for a in range(0, n_ops, max_ops_per_segment)]

    # Global use positions per gate value.
    gate_uses: dict[int, list[int]] = {}
    for g, row in enumerate(exec_rows):
        for arg, _flag in row[2]:
            if arg >= n_b + n_h:
                gate_uses.setdefault(arg, []).append(g)

    # ---- per-segment staging plans (mirrors the plain scheduler) ----
    seg_plans = []
    for a, b in segments_rng:
        reads: dict[int, list[int]] = {}
        for g in range(a, b):
            for arg, _flag in exec_rows[g][2]:
                if arg < n_b:
                    reads.setdefault(arg, []).append(g)
        cfu: dict[int, int] = {}
        for s, gs in reads.items():
            c = chunk_of[s]
            cfu[c] = min(cfu.get(c, _INF), gs[0])
        chunks = sorted(cfu, key=lambda c: (cfu[c], c))
        seq_of = {c: i for i, c in enumerate(chunks)}
        spilled: set[int] = set()
        for s, gs in reads.items():
            sq = seq_of[chunk_of[s]]
            if sq + n_bufs < len(chunks) and \
                    gs[-1] >= cfu[chunks[sq + n_bufs]]:
                spilled.add(s)
        # Buffer-clear point per chunk: after its last *direct* stage
        # read; spill-only chunks clear right after their wait's spill
        # copies (intra-op, via the sequence ordering below).
        nonspill_last: dict[int, int | None] = {c: None for c in chunks}
        for s, gs in reads.items():
            if s not in spilled:
                c = chunk_of[s]
                if nonspill_last[c] is None or gs[-1] > nonspill_last[c]:
                    nonspill_last[c] = gs[-1]
        # Chunk events per op, ordered by (seq, start-before-wait): a
        # successor's start always follows its ring blocker's wait and
        # spill copies, even within one op's event bucket.
        events_at: dict[int, list[tuple[int, int, int]]] = {}
        for sq, c in enumerate(chunks):
            if sq < n_bufs:
                at = a
            else:
                blocker = chunks[sq - n_bufs]
                nr = nonspill_last[blocker]
                at = cfu[blocker] if nr is None else nr + 1
            w = cfu[c]
            if at > w:   # pragma: no cover - the spill rule prevents it
                raise LogicError(
                    f"spill schedule: chunk {c} must start after op {at} "
                    f"but is needed at op {w} (gate fan-in spans over "
                    f"{n_bufs} chunks of {chunk_tiles} tiles)")
            events_at.setdefault(at, []).append((sq, 0, c))
            events_at.setdefault(w, []).append((sq, 1, c))
        for evs in events_at.values():
            evs.sort()
        spills_of_chunk: dict[int, list[int]] = {}
        for s in sorted(spilled, key=stage_pos.__getitem__):
            spills_of_chunk.setdefault(chunk_of[s], []).append(s)
        seg_plans.append(dict(
            rng=(a, b), reads=reads, seq_of=seq_of, spilled=spilled,
            events_at=events_at, spills_of_chunk=spills_of_chunk))

    # ---- pass A: Belady simulation over the whole program ----------
    # Produces a provisional event stream; each event's index is its
    # "time".  Residency and the free list persist across segments
    # (the pool dumps/reloads wholesale at boundaries).
    stream: list = []
    refills: list[dict] = []
    resident: dict[int, int] = {}
    free: list[tuple[int, int]] = [(slot, -1) for slot in range(P - 1, -1, -1)]
    heap: list[tuple[int, int]] = []   # (-next_use, value)
    last_evict_time: dict[int, int] = {}
    use_ptr: dict[int, int] = {}
    seg_reads: dict[int, list[int]] = {}   # live only within a segment
    last_barrier = 0   # Most recent pool-wide dump/load (no DMA across).

    def next_use(v: int, after: int) -> int:
        uses = seg_reads.get(v) if v < n_b else gate_uses.get(v)
        if not uses:
            return _INF
        i = use_ptr.get(v, 0)
        while i < len(uses) and uses[i] < after:
            i += 1
        use_ptr[v] = i
        return uses[i] if i < len(uses) else _INF

    def alloc(g: int, protect: set[int]) -> tuple[int, int]:
        if free:
            return free.pop()
        aside = []
        victim = None
        while heap:
            negnu, v = heapq.heappop(heap)
            if v not in resident:
                continue
            cur = next_use(v, g)
            if -negnu != cur:
                heapq.heappush(heap, (-cur, v))
                continue
            if v in protect:
                aside.append((negnu, v))
                continue
            victim = v
            break
        for item in aside:
            heapq.heappush(heap, item)
        if victim is None:
            raise LogicError(
                f"spill schedule: pool of {P} tiles exhausted by "
                f"protected values at op {g}")
        slot = resident.pop(victim)
        t = len(stream)
        stream.append(("evict", victim, slot))
        last_evict_time[victim] = t
        return slot, t

    def ensure_resident(arg: int, g: int, protect: set[int]):
        if arg in resident:
            heapq.heappush(heap, (-next_use(arg, g + 1), arg))
            return
        slot, freed_t = alloc(g, protect)
        src = 0 if arg < n_b else 1
        rec = dict(value=arg, src=src,
                   row=stage_pos[arg] if arg < n_b else None,
                   slot=slot, free_time=freed_t,
                   evict_time=last_evict_time.get(arg, -1),
                   barrier_time=last_barrier,
                   consume_time=None, k=len(refills))
        refills.append(rec)
        stream.append(("refill", rec))
        resident[arg] = slot
        heapq.heappush(heap, (-next_use(arg, g + 1), arg))

    for si, plan in enumerate(seg_plans):
        a, b = plan["rng"]
        last_barrier = len(stream)
        stream.append(("seg_begin", si))
        if si > 0:
            last_barrier = len(stream)
            stream.append(("load",))
        seg_reads = {s: gs for s, gs in plan["reads"].items()
                     if s in plan["spilled"]}
        for v in seg_reads:
            use_ptr[v] = 0
        seq_of, n_seg_chunks = plan["seq_of"], len(plan["seq_of"])
        for g in range(a, b):
            kind, out, args, aux = exec_rows[g]
            pool_args = [s for s, _f in args
                         if s >= n_b + n_h
                         or (s < n_b and s in plan["spilled"])]
            protect = set(pool_args) | {out}
            for _sq, ckind, c in plan["events_at"].get(g, ()):
                buf = seq_of[c] % n_bufs
                if ckind == 0:
                    stream.append(("cstart", c, buf))
                    continue
                stream.append(("cwait", c, buf))
                for s in plan["spills_of_chunk"].get(c, ()):
                    slot, _ft = alloc(g, protect | {s})
                    resident[s] = slot
                    stream.append(("sbspill", buf,
                                   stage_pos[s] % chunk_tiles, slot, s))
                    heapq.heappush(heap, (-next_use(s, g), s))
            for arg in pool_args:
                ensure_resident(arg, g, protect)
            out_slot, _ft = alloc(g, protect)
            resident[out] = out_slot
            locs = []
            for arg, flag in args:
                if arg < n_b and arg not in plan["spilled"]:
                    pos = stage_pos[arg]
                    locs.append((("stage",
                                  seq_of[chunk_of[arg]] % n_bufs,
                                  pos % chunk_tiles), flag))
                elif arg < n_b + n_h and arg >= n_b:
                    locs.append((("house", arg - n_b), flag))
                else:
                    locs.append((("pool", resident[arg]), flag))
            stream.append(("gate", kind, out_slot, locs, aux))
            t = len(stream) - 1
            # Frees: dead args, and never-consumed outputs.
            for arg in set(pool_args):
                if arg in resident and next_use(arg, g + 1) == _INF:
                    free.append((resident.pop(arg), t))
            if out != top_index and next_use(out, g + 1) == _INF:
                free.append((resident.pop(out), t))
            else:
                heapq.heappush(heap, (-next_use(out, g + 1), out))
        # Segment-local spilled basics must be dead by now.
        for s in seg_reads:
            if s in resident:   # pragma: no cover - defensive
                free.append((resident.pop(s), len(stream)))
        if si < len(seg_plans) - 1:
            last_barrier = len(stream)
            stream.append(("dump",))

    if top_index not in resident:   # pragma: no cover - defensive
        raise LogicError("spill schedule lost the top value")
    top_slot = resident[top_index]

    # ---- pass B: placement + concrete op emission ------------------
    # Scratch rows [0, P) are the boundary-dump region; evicted values
    # append from P in emission order so every flush is contiguous.
    for rec in refills:
        rec["consume_time"] = None
    # consume_time = stream index of the refill marker.
    for t, ev in enumerate(stream):
        if ev[0] == "refill":
            ev[1]["consume_time"] = t
    starts_at_time: dict[int, list[dict]] = {}
    for rec in refills:
        t0 = max(rec["free_time"] + 1, rec["evict_time"] + 1,
                 rec["barrier_time"] + 1,
                 rec["consume_time"] - hoist_events)
        starts_at_time.setdefault(t0, []).append(rec)

    segments: list[list] = []
    ops: list = []
    scratch_row: dict[int, int] = {}
    next_row = P
    slab_buf, slab_off = 0, 0
    batch_start_off, batch_start_row = 0, P
    open_batches: list[dict] = []      # started, not yet waited
    batch_count = 0
    unflushed_rows: dict[int, int] = {}   # row -> slab position marker
    sem_free = [True] * n_refill_sems
    start_queue: list[dict] = []
    # Strict per-sem FIFO: refill k uses sem k % R and may start only
    # once every smaller-k refill on that sem has been waited —
    # otherwise a hoisted later start could race an in-flight earlier
    # DMA on the same semaphore.
    from collections import deque
    sem_fifo = [deque() for _ in range(n_refill_sems)]
    for rec in refills:
        sem_fifo[rec["k"] % n_refill_sems].append(rec["k"])

    def flush_slab():
        """Start a flush of the open slab range (if any)."""
        nonlocal batch_start_off, batch_start_row, batch_count
        n = slab_off - batch_start_off
        if n <= 0:
            return
        sem = batch_count % n_flush_sems
        batch_count += 1
        # FIFO discipline per flush sem: wait any open batch on it.
        for bobj in [x for x in open_batches if x["sem"] == sem]:
            emit_efwait(bobj)
        bobj = dict(buf=slab_buf, off0=batch_start_off, n=n,
                    row0=batch_start_row, sem=sem, waited=False)
        ops.append(("efstart", bobj["buf"], bobj["off0"], n,
                    bobj["row0"], sem))
        open_batches.append(bobj)
        for r in range(bobj["row0"], bobj["row0"] + n):
            unflushed_rows.pop(r, None)
            flushed_batch_of[r] = bobj
        batch_start_off = slab_off
        batch_start_row = next_row

    flushed_batch_of: dict[int, dict] = {}

    def emit_efwait(bobj: dict):
        if bobj["waited"]:
            return
        ops.append(("efwait", bobj["buf"], bobj["off0"], bobj["n"],
                    bobj["row0"], bobj["sem"]))
        bobj["waited"] = True
        if bobj in open_batches:
            open_batches.remove(bobj)

    def rotate_slab():
        nonlocal slab_buf, slab_off, batch_start_off, batch_start_row
        flush_slab()
        slab_buf ^= 1
        slab_off = 0
        batch_start_off = 0
        batch_start_row = next_row
        # The new buffer's previous batches must be done before reuse.
        for bobj in [x for x in open_batches if x["buf"] == slab_buf]:
            emit_efwait(bobj)

    def ensure_row_readable(row: int):
        """A refill is about to read ``row``: force its flush home."""
        if row in unflushed_rows:
            flush_slab()
        bobj = flushed_batch_of.get(row)
        if bobj is not None and not bobj["waited"]:
            emit_efwait(bobj)

    def emit_rstart(rec: dict):
        row = rec["row"] if rec["src"] == 0 else scratch_row[rec["value"]]
        if rec["src"] == 1:
            ensure_row_readable(row)
        sem = rec["k"] % n_refill_sems
        assert sem_fifo[sem][0] == rec["k"], "refill sem FIFO violated"
        sem_fifo[sem].popleft()
        ops.append(("rstart", rec["src"], row, rec["slot"], sem))
        rec["started"] = True
        rec["sem"] = sem
        sem_free[sem] = False

    def drain_start_queue():
        kept = []
        for rec in start_queue:
            sem = rec["k"] % n_refill_sems
            if not rec.get("started") and sem_free[sem] \
                    and sem_fifo[sem][0] == rec["k"]:
                emit_rstart(rec)
            elif not rec.get("started"):
                kept.append(rec)
        start_queue[:] = kept

    n_refill_total = len(refills)
    for t, ev in enumerate(stream):
        for rec in starts_at_time.get(t, ()):
            start_queue.append(rec)
        drain_start_queue()
        tag = ev[0]
        if tag == "seg_begin":
            if ops:
                segments.append(ops)
                ops = []
        elif tag == "load":
            ops.append(("lstart",))
            ops.append(("lwait",))
        elif tag == "dump":
            # Slab must land before the call ends; outstanding refills
            # were all waited (consumers precede the boundary).
            flush_slab()
            for bobj in list(open_batches):
                emit_efwait(bobj)
            ops.append(("dstart",))
            ops.append(("dwait",))
        elif tag == "cstart":
            ops.append(("start", ev[1], ev[2]))
        elif tag == "cwait":
            ops.append(("wait", ev[1], ev[2]))
        elif tag == "sbspill":
            ops.append(("spill", ev[1], ev[2], ev[3]))
        elif tag == "evict":
            _tag, v, slot = ev
            if v >= n_b and v not in scratch_row:
                if slab_off == slab_tiles:
                    rotate_slab()
                scratch_row[v] = next_row
                unflushed_rows[next_row] = True
                ops.append(("evict", slot, slab_buf, slab_off))
                slab_off += 1
                next_row += 1
            # Basics and re-evictions: the HBM copy already exists.
        elif tag == "refill":
            rec = ev[1]
            if not rec.get("started"):
                if rec in start_queue:
                    start_queue.remove(rec)
                emit_rstart(rec)
            ops.append(("rwait", rec["src"],
                        rec["row"] if rec["src"] == 0
                        else scratch_row[rec["value"]],
                        rec["slot"], rec["sem"]))
            sem_free[rec["sem"]] = True
            drain_start_queue()
        else:  # ("gate", kind, out_slot, locs, aux)
            ops.append(ev)
    # Final segment: land any in-flight flushes (nothing reads the
    # rows, but Pallas requires started DMAs to be waited).
    for bobj in list(open_batches):
        emit_efwait(bobj)
    segments.append(ops)

    scratch_rows = next_row
    bufs = min(n_chunks_layout, n_bufs)
    vmem = (bufs * chunk_tiles + P + 2 * slab_tiles) * _TILE_BYTES
    if vmem > vmem_budget:
        raise LogicError(
            f"spill schedule needs {vmem} bytes VMEM "
            f"(budget {vmem_budget})")

    return SpillProgram(
        segments=segments, basic_perm=basic_perm, n_basic=n_b,
        n_basic_pad=n_basic_pad, chunk_tiles=chunk_tiles,
        n_chunks=n_chunks_layout, n_bufs=n_bufs, pool_slots=P,
        slab_tiles=slab_tiles, n_flush_sems=n_flush_sems,
        n_refill_sems=n_refill_sems, scratch_rows=scratch_rows,
        top_slot=top_slot, nnz=nnz, n_ops=n_ops, n_house=n_h,
        n_evicted=len(scratch_row), n_refills=n_refill_total)


# ---------------------------------------------------------------------------
# Host-side reference interpreter (semantics + hazard checking).


def simulate_spill_program(program: SpillProgram, basic_p: np.ndarray,
                           house: np.ndarray) -> float:
    """Execute a spill program on scalars with async-hazard checking.

    ``basic_p``: (n_basic,) float probabilities for one trial.  Models
    every DMA as (start: snapshot source, wait: commit to destination)
    and asserts the schedule never reads an uncommitted destination or
    rewrites an in-flight source — the ordering bugs interpret-mode
    Pallas can mask.  Gate math runs in float32 with the kernel's
    reduction order, so the result matches the gather engine (and the
    kernel) bit-for-bit.
    """
    f32 = np.float32
    one, two = f32(1.0), f32(2.0)
    n_b = program.n_basic
    staged = np.zeros(program.n_basic_pad, dtype=f32)
    staged[:n_b] = np.asarray(basic_p, dtype=f32)[program.basic_perm]
    ct = program.chunk_tiles
    stage = np.full((program.n_bufs, ct), np.nan, dtype=f32)
    stage_chunk = [-1] * program.n_bufs       # committed chunk per buffer
    pending_chunk: dict[int, tuple[int, np.ndarray]] = {}
    pool = np.full(program.pool_slots, np.nan, dtype=f32)
    pool_inflight: set[int] = set()
    slab = np.full((2, program.slab_tiles), np.nan, dtype=f32)
    slab_inflight: set[tuple[int, int]] = set()
    scratch = np.full(program.scratch_rows, np.nan, dtype=f32)
    scratch_ready = np.zeros(program.scratch_rows, dtype=bool)
    pending_flush: dict[tuple, np.ndarray] = {}
    pending_refill: dict[tuple, float] = {}
    pending_dump: np.ndarray | None = None
    pending_load: np.ndarray | None = None
    refill_sem_busy: dict[int, int] = {}
    flush_sem_busy: dict[int, int] = {}

    def read(loc):
        tag = loc[0]
        if tag == "pool":
            assert loc[1] not in pool_inflight, \
                f"read of in-flight pool slot {loc[1]}"
            v = pool[loc[1]]
            assert not np.isnan(v), f"read of undefined pool slot {loc[1]}"
            return v
        if tag == "stage":
            buf, off = loc[1], loc[2]
            assert stage_chunk[buf] >= 0, f"read of unwaited buffer {buf}"
            assert buf not in pending_chunk, \
                f"read of buffer {buf} with an in-flight chunk DMA"
            return stage[buf, off]
        return f32(house[loc[1]])

    top = None
    for ops in program.segments:
        for op in ops:
            tag = op[0]
            if tag == "start":
                c, buf = op[1], op[2]
                assert buf not in pending_chunk, \
                    f"chunk start overlaps pending on buffer {buf}"
                pending_chunk[buf] = (c, staged[c * ct:(c + 1) * ct].copy())
            elif tag == "wait":
                c, buf = op[1], op[2]
                pc, data = pending_chunk.pop(buf)
                assert pc == c, f"chunk wait mismatch: {pc} != {c}"
                stage[buf, :len(data)] = data
                stage_chunk[buf] = c
            elif tag == "spill":
                buf, off, slot = op[1], op[2], op[3]
                assert stage_chunk[buf] >= 0
                assert buf not in pending_chunk, \
                    f"spill from buffer {buf} with an in-flight chunk DMA"
                assert slot not in pool_inflight
                pool[slot] = stage[buf, off]
            elif tag == "evict":
                slot, sbuf, soff = op[1], op[2], op[3]
                assert (sbuf, soff) not in slab_inflight, \
                    "evict rewrites an in-flight slab tile"
                assert slot not in pool_inflight
                assert not np.isnan(pool[slot]), "evict of undefined slot"
                slab[sbuf, soff] = pool[slot]
            elif tag == "efstart":
                _t, sbuf, off0, n, row0, sem = op
                assert sem not in flush_sem_busy, \
                    f"flush sem {sem} reused while pending"
                key = (sbuf, off0, n, row0, sem)
                pending_flush[key] = slab[sbuf, off0:off0 + n].copy()
                for i in range(n):
                    slab_inflight.add((sbuf, off0 + i))
                flush_sem_busy[sem] = 1
            elif tag == "efwait":
                _t, sbuf, off0, n, row0, sem = op
                key = (sbuf, off0, n, row0, sem)
                data = pending_flush.pop(key)
                scratch[row0:row0 + n] = data
                scratch_ready[row0:row0 + n] = True
                for i in range(n):
                    slab_inflight.discard((sbuf, off0 + i))
                del flush_sem_busy[sem]
            elif tag == "rstart":
                _t, src, row, slot, sem = op
                assert sem not in refill_sem_busy, \
                    f"refill sem {sem} reused while pending"
                if src == 0:
                    value = staged[row]
                else:
                    assert scratch_ready[row], \
                        f"refill reads unflushed scratch row {row}"
                    value = scratch[row]
                pending_refill[(src, row, slot, sem)] = value
                pool_inflight.add(slot)
                refill_sem_busy[sem] = 1
            elif tag == "rwait":
                _t, src, row, slot, sem = op
                value = pending_refill.pop((src, row, slot, sem))
                pool_inflight.discard(slot)
                pool[slot] = value
                del refill_sem_busy[sem]
            elif tag == "dstart":
                assert pending_dump is None
                assert not pool_inflight
                pending_dump = pool.copy()
            elif tag == "dwait":
                scratch[:program.pool_slots] = pending_dump
                scratch_ready[:program.pool_slots] = True
                pending_dump = None
            elif tag == "lstart":
                assert pending_load is None
                assert not pending_refill and not pending_dump
                assert scratch_ready[:program.pool_slots].all(), \
                    "load before any dump reached the scratch"
                pending_load = scratch[:program.pool_slots].copy()
            elif tag == "lwait":
                pool[:] = pending_load
                pending_load = None
            else:  # ("gate", kind, out_slot, locs, aux)
                _tag, kind, out_slot, locs, aux = op
                assert out_slot not in pool_inflight
                if kind == "prod":
                    acc = one
                    for loc, flip in locs:
                        v = read(loc)
                        acc = acc * ((one - v) if flip else v)
                    value = one - acc if aux else acc
                elif kind == "pair":
                    (l0, f0), (l1, f1) = locs
                    va = one - read(l0) if f0 else read(l0)
                    vb = one - read(l1) if f1 else read(l1)
                    x = va + vb - two * va * vb
                    value = one - x if aux else x
                else:  # count
                    lo, hi = aux
                    cap = hi + 1
                    dp = [one] + [f32(0.0)] * cap
                    for loc, neg in locs:
                        v = read(loc)
                        if neg:
                            v = one - v
                        new = [dp[0] * (one - v)]
                        for k in range(1, cap):
                            new.append(dp[k] * (one - v) + dp[k - 1] * v)
                        new.append(dp[cap] + dp[cap - 1] * v)
                        dp = new[:cap] + [new[cap]]
                    value = f32(sum(dp[k] for k in range(lo, hi + 1)))
                pool[out_slot] = value
        # Call boundary: all DMAs must have been waited.
        assert not pending_chunk, "chunk DMA crosses a segment boundary"
        assert not pending_flush, "flush DMA crosses a segment boundary"
        assert not pending_refill, "refill DMA crosses a segment boundary"
        assert pending_dump is None and pending_load is None
        top = pool[program.top_slot]
    return float(top)
