"""Replay-stream spill engine: coalesced refills for thrashing trees.

The round-3 spill tier (``compiler/spill.py``) removed the live-set wall
but sat on the single-tile refill DMA floor (~32 GB/s measured on v5e):
30k scattered (8, 128)-tile refills per grid step are issue-rate-bound,
not bandwidth-bound.  This module replaces scattered refills with
*replay streams* — the classic scatter-to-stream transformation:

* **Basic events have no staging ring at all.**  Every basic read gets
  its own entry in a *basic replay stream*, laid out in read order and
  built once at stage time by one XLA gather (``stage_replay``).  The
  kernel streams it through a small ring of chunk DMAs at full HBM
  bandwidth; a read is a static ``(buf, off)`` VMEM index.  Duplication
  (one tile per *read*, not per event) trades HBM capacity for
  bandwidth — measured on v5e, 66k coalesced tiles cost ~0.4 ms where
  22k scattered single-tile DMAs cost ~5.5 ms.
* **The VMEM pool holds gate values only** (Belady-scheduled, as in the
  spill tier) — freeing basics from the pool cuts gate evictions.
* **Evictions append to a slab ring** (VPU copies) whose buffers flush
  contiguously to an eviction-ordered HBM scratch log.  A re-read whose
  arc is *short* (81% of thrash re-reads are within 64 evictions,
  measured on the 65k uniform tree) reads **directly from the slab
  ring** — zero DMA.
* **Re-reads whose arc crosses a segment boundary** are coalesced by an
  XLA gather at the boundary: it materializes the next segment's *gate
  replay stream* from the scratch log in read order, and the kernel
  streams it like the basic stream.
* Only the residual mid-range arcs (same segment, past the slab window
  — ~10% of re-reads) pay a single-tile refill DMA into the pool,
  prefetched ``hoist_events`` ahead under a FIFO semaphore pool.

The output is a :class:`ReplayProgram` — per-segment straight-line op
lists executed by ``ops/stream_kernel.replay_propagate_staged`` (one
``pallas_call`` per segment, scratch threaded through the chain, XLA
gathers between).  A host-side reference interpreter
(:func:`simulate_replay_program`) executes the same grammar with async-
hazard checking, so schedules validate on CPU without a TPU.

Reference anchor: the quantification engine the reference specifies but
never built (``settings.h:13-22``, the absent ``src/bool/bool`` —
SURVEY.md §2.6) at config-3 scale, with the memory hierarchy scheduled
for the TPU: VMEM pool for the DFS working set, slab ring for short
reuse, sequential HBM replay streams for everything else.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np

from ..errors import LogicError
from .graph import CompiledTree
from .schedule import _TILE_BYTES, _VMEM_BUDGET, _dfs_exec_rows, _emit_gate_ops

__all__ = ["ReplayProgram", "build_replay_schedule",
           "simulate_replay_program"]

_INF = 1 << 60


@dataclasses.dataclass
class ReplayProgram:
    """A segmented replay-stream program.

    ``segments[k]`` is a straight-line op list:

    - ``("bstart"/"bwait", chunk, buf)`` — basic replay stream chunk DMA
      (``brs[i*brs_len_pad + chunk*brs_chunk : +brs_chunk]`` into ring
      buffer ``buf``).
    - ``("gstart"/"gwait", chunk, buf)`` — gate replay stream chunk DMA
      from this segment's gathered array (local chunk index).
    - ``("evict", pool_slot, sbuf, soff)`` — VPU copy into the slab
      ring.
    - ``("fstart"/"fwait", sbuf, off0, n, row0, sem)`` — flush slab
      range to scratch rows ``[row0, row0+n)``.
    - ``("rstart"/"rwait", row, slot, sem)`` — single-tile intra-segment
      refill from scratch into the pool.
    - ``("dstart"/"dwait")`` / ``("lstart"/"lwait")`` — whole-pool
      dump/load to/from scratch rows ``[0, pool_slots)`` at segment
      boundaries.
    - ``("gate", kind, out_slot, locs, aux)`` — evaluate one gate;
      ``locs`` entries are ``("pool", slot)``, ``("brs", buf, off)``,
      ``("grs", buf, off)``, ``("slab", sbuf, soff)`` or
      ``("house", pos)``.

    ``brs_cols[p]`` is the basic column feeding basic-stream position
    ``p`` (the whole staged input is this stream); ``grs_rows[k]`` are
    the scratch rows (un-offset) gathered into segment ``k``'s gate
    stream.  Scratch rows: ``[0, pool_slots)`` boundary dumps, then one
    row per eviction event in eviction order.
    """

    segments: list
    brs_cols: np.ndarray
    brs_len_pad: int
    brs_chunk: int
    brs_bufs: int
    #: Hybrid resident-basic tier: the first ``res_tiles`` staged rows
    #: of every trial-tile block hold one tile per RESIDENT basic (high
    #: reuse), loaded whole into VMEM at each segment start
    #: (``("rlstart",)/("rlwait",)``) and read as ``("rbas", idx)`` —
    #: replacing per-read stream duplication for those basics
    #: (docs/CAPABILITIES gap: replay stream duplication vs staging
    #: ring).  0 = pure per-read stream.
    res_tiles: int
    grs_rows: list        # per segment: np.ndarray of scratch rows (padded)
    grs_len: list         # per segment: raw (unpadded) entry count
    grs_len_pad: list     # per segment: padded length (0 = no stream)
    grs_chunk: int
    grs_bufs: int
    pool_slots: int
    slab_bufs: int
    slab_tiles: int
    n_flush_sems: int
    n_refill_sems: int
    scratch_rows: int
    top_slot: int
    nnz: int
    n_ops: int
    n_basic: int
    n_house: int
    n_evicted: int
    n_intra: int
    n_inter: int
    n_slab_reads: int
    n_resident_reads: int
    #: Semantic trace for the adjoint compiler: residency intervals,
    #: per-gate routed arg semantics, per-segment event order.
    trace: dict | None = None

    @property
    def vmem_bytes(self) -> int:
        return (self.brs_bufs * self.brs_chunk
                + self.grs_bufs * self.grs_chunk
                + self.pool_slots + self.res_tiles
                + self.slab_bufs * self.slab_tiles) * _TILE_BYTES


def build_replay_schedule(tree: CompiledTree, brs_chunk: int = 256,
                          brs_bufs: int = 3, grs_chunk: int = 128,
                          grs_bufs: int = 2, slab_bufs: int = 4,
                          slab_tiles: int = 64,
                          max_ops_per_segment: int = 8192,
                          pool_slots: int | None = None,
                          hoist_events: int = 64,
                          n_refill_sems: int = 16,
                          n_flush_sems: int = 4,
                          resident_tiles: int = 0,
                          vmem_budget: int = _VMEM_BUDGET) -> ReplayProgram:
    """Compile ``tree`` into a :class:`ReplayProgram`.

    ``resident_tiles`` > 0 enables the hybrid basic tier: up to that
    many high-reuse basics (those read more often than once per
    segment) are staged once per trial tile and held in VMEM for the
    whole segment instead of being duplicated per read in the stream —
    trading ``resident_tiles`` tiles of VMEM (taken from the pool) for
    a smaller staged array and less stream bandwidth.

    Raises :class:`LogicError` only for structurally impossible inputs
    (no basics, a single gate wider than the pool or the stream rings).
    """
    if tree.top_index is None:
        raise LogicError("replay schedule needs an anchored top event")
    return _build_replay(_emit_gate_ops(tree), tree.n_basic, tree.n_house,
                         tree.top_index, brs_chunk, brs_bufs, grs_chunk,
                         grs_bufs, slab_bufs, slab_tiles,
                         max_ops_per_segment, pool_slots, hoist_events,
                         n_refill_sems, n_flush_sems, resident_tiles,
                         vmem_budget)


def _build_replay(gate_rows, n_basic, n_house, top_index, brs_chunk,
                  brs_bufs, grs_chunk, grs_bufs, slab_bufs, slab_tiles,
                  max_ops_per_segment, pool_slots, hoist_events,
                  n_refill_sems, n_flush_sems, resident_tiles,
                  vmem_budget):
    if n_basic == 0:
        raise LogicError("replay schedule needs at least one basic event")
    n_b, n_h = n_basic, n_house
    exec_rows = _dfs_exec_rows(gate_rows, n_b, n_h, top_index)
    n_ops = len(exec_rows)
    nnz = sum(len(row[2]) for row in exec_rows)
    n_segs = -(-n_ops // max_ops_per_segment)
    seg_of = lambda g: g // max_ops_per_segment  # noqa: E731

    # Resident-basic selection (hybrid tier): basics read more often
    # than once per segment earn a permanent VMEM tile — each such
    # basic trades its per-read stream entries for one reload per
    # segment, so the threshold is exactly the break-even point.
    res_index: dict[int, int] = {}
    res_pad = 0
    res_cols = np.zeros(0, dtype=np.int64)
    if resident_tiles > 0:
        counts: dict[int, int] = {}
        for row in exec_rows:
            for a, _f in row[2]:
                if a < n_b:
                    counts[a] = counts.get(a, 0) + 1
        worth = sorted(((cnt, c) for c, cnt in counts.items()
                        if cnt > n_segs), reverse=True)
        n_res = min(resident_tiles, len(worth))
        if pool_slots is None:
            # The tier takes VMEM from the gate pool; keep the pool at
            # least half the budget remainder (a starved pool's extra
            # evictions cost more than the stream tiles saved).
            budget_t = vmem_budget // _TILE_BYTES
            ring_t = (brs_bufs * brs_chunk + grs_bufs * grs_chunk
                      + slab_bufs * slab_tiles)
            n_res = max(0, min(n_res, (budget_t - ring_t) // 2))
        chosen = sorted(c for _cnt, c in worth[:n_res])
        if chosen:
            res_index = {c: i for i, c in enumerate(chosen)}
            res_pad = -(-len(chosen) // brs_chunk) * brs_chunk
            res_cols = np.zeros(res_pad, dtype=np.int64)
            res_cols[:len(chosen)] = chosen

    # Pool size from the VMEM budget.
    budget_tiles = vmem_budget // _TILE_BYTES
    ring_tiles = (brs_bufs * brs_chunk + grs_bufs * grs_chunk
                  + slab_bufs * slab_tiles)
    if pool_slots is None:
        pool_slots = budget_tiles - ring_tiles - res_pad
    max_fanin = max((len(row[2]) for row in exec_rows), default=0)
    if pool_slots < max_fanin + 2:
        raise LogicError(
            f"replay schedule: pool of {pool_slots} tiles cannot hold a "
            f"fan-in-{max_fanin} gate's working set")
    if max_fanin >= (brs_bufs - 1) * brs_chunk:
        raise LogicError(
            f"replay schedule: fan-in {max_fanin} exceeds the basic "
            f"stream ring window ({brs_bufs}x{brs_chunk} tiles)")
    if max_fanin >= (grs_bufs - 1) * grs_chunk:
        raise LogicError(
            f"replay schedule: fan-in {max_fanin} exceeds the gate "
            f"stream ring window ({grs_bufs}x{grs_chunk} tiles)")
    P = pool_slots
    slab_window = slab_bufs * slab_tiles

    gate_uses: dict[int, list[int]] = {}
    for g, row in enumerate(exec_rows):
        for arg, _flag in row[2]:
            if arg >= n_b + n_h:
                gate_uses.setdefault(arg, []).append(g)

    # ---- pass A: routing + Belady over the gate pool ----------------
    stream: list = []            # flat event stream
    brs_cols: list[int] = []     # basic column per stream position
    brs_seg_end: list[int] = []  # stream position count at each seg end
    grs_rows: list[list[int]] = [[] for _ in range(n_segs)]
    refills: list[dict] = []
    resident: dict[int, int] = {}
    free: list[tuple[int, int]] = [(s, -1) for s in range(P - 1, -1, -1)]
    heap: list[tuple[int, int]] = []
    use_ptr: dict[int, int] = {}
    E = 0                        # eviction event counter
    last_evict: dict[int, tuple[int, int]] = {}   # value -> (e, seg)
    n_intra = n_inter = n_slab_reads = n_resident_reads = 0
    last_barrier = 0

    evict_t: list[int] = []      # stream index of each eviction event

    # Semantic trace for the adjoint compiler (compiler/replay_adjoint):
    # residency intervals per value, per-gate routed arg semantics, the
    # eviction/refill event order per segment.
    tr_intervals: list[dict] = []
    tr_cur: dict[int, int] = {}          # value -> open interval id
    tr_gates: list[dict] = []
    tr_evicts: list[dict] = []
    tr_seg_events: list[list] = [[] for _ in range(n_segs)]

    def next_use(v: int, after: int) -> int:
        uses = gate_uses.get(v)
        if not uses:
            return _INF
        i = use_ptr.get(v, 0)
        while i < len(uses) and uses[i] < after:
            i += 1
        use_ptr[v] = i
        return uses[i] if i < len(uses) else _INF

    def evict_one(g: int, protect: set[int]) -> tuple[int, int]:
        """Evict the Belady victim; returns (slot, free_time)."""
        nonlocal E
        aside, victim = [], None
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
                f"replay schedule: pool of {P} tiles exhausted by "
                f"protected values at op {g}")
        slot = resident.pop(victim)
        e = E
        E += 1
        last_evict[victim] = (e, seg_of(g))
        iid = tr_cur.pop(victim)
        tr_intervals[iid]["end"] = ("evict", e)
        tr_evicts.append(dict(value=victim, slot=slot, seg=seg_of(g),
                              interval=iid))
        tr_seg_events[seg_of(g)].append(("evict", e))
        t = len(stream)
        evict_t.append(t)
        stream.append(("evict", slot, e))
        return slot, t

    def alloc(g: int, protect: set[int]) -> tuple[int, int]:
        if free:
            return free.pop()
        return evict_one(g, protect)

    for g, row in enumerate(exec_rows):
        s = seg_of(g)
        if g % max_ops_per_segment == 0:
            if g > 0:
                brs_seg_end.append(len(brs_cols))
                stream.append(("dump",))
            stream.append(("seg_begin", s))
            if g > 0:
                stream.append(("load",))
            # Refills must start strictly after the pool reload (their
            # slot DMA races the whole-pool load otherwise).
            last_barrier = len(stream) - 1
        kind, out, args, aux = row
        protect = {a for a, _f in args if a >= n_b + n_h} | {out}
        locs = []
        sem_args = []
        for ai, (arg, flag) in enumerate(args):
            if arg < n_b:
                if arg in res_index:
                    loc = ("rbas", res_index[arg])
                    sem_args.append((loc, flag))
                    locs.append((loc, flag))
                    n_resident_reads += 1
                    continue
                sem_args.append((("brs", len(brs_cols)), flag))
                locs.append((("brs", len(brs_cols)), flag))
                brs_cols.append(arg)
                continue
            if arg < n_b + n_h:
                sem_args.append((("house", arg - n_b), flag))
                locs.append((("house", arg - n_b), flag))
                continue
            if arg in resident:
                iid = tr_cur[arg]
                tr_intervals[iid]["reads"].append((g, ai))
                sem_args.append((("pool", iid), flag))
                locs.append((("pool", resident[arg]), flag))
                heapq.heappush(heap, (-next_use(arg, g + 1), arg))
                continue
            e, es = last_evict[arg]
            # Margin: allocations later in this op can advance E past
            # the reuse point of position e.
            margin = len(args) + 1
            if es == s and E + margin < (e // slab_tiles
                                         + slab_bufs) * slab_tiles:
                sem_args.append((("slab", e), flag))
                locs.append((("slab", (e // slab_tiles) % slab_bufs,
                              e % slab_tiles), flag))
                n_slab_reads += 1
            elif es < s:
                sem_args.append((("grs", s, len(grs_rows[s])), flag))
                locs.append((("grs", s, len(grs_rows[s])), flag))
                grs_rows[s].append(P + e)
                n_inter += 1
            else:
                slot, freed_t = alloc(g, protect)
                rec = dict(value=arg, row=P + e, slot=slot,
                           free_time=freed_t, evict_event=e,
                           evict_time=evict_t[e],
                           barrier_time=last_barrier,
                           consume_time=None, k=len(refills), seg=s)
                iid = len(tr_intervals)
                tr_intervals.append(dict(slot=slot,
                                         start=("refill", rec["k"]),
                                         end=None, reads=[(g, ai)]))
                tr_cur[arg] = iid
                rec["interval"] = iid
                tr_seg_events[s].append(("refill", rec["k"]))
                refills.append(rec)
                stream.append(("refill", rec))
                resident[arg] = slot
                heapq.heappush(heap, (-next_use(arg, g + 1), arg))
                n_intra += 1
                sem_args.append((("pool", iid), flag))
                locs.append((("pool", slot), flag))
        # Free dead resident args before allocating the output.
        for arg in {a for a, _f in args}:
            if arg >= n_b + n_h and arg in resident \
                    and next_use(arg, g + 1) == _INF:
                free.append((resident.pop(arg), len(stream)))
                tr_intervals[tr_cur.pop(arg)]["end"] = ("death",)
        out_slot, _ft = alloc(g, protect)
        resident[out] = out_slot
        out_iid = len(tr_intervals)
        tr_intervals.append(dict(slot=out_slot, start=("def", g),
                                 end=None, reads=[]))
        tr_cur[out] = out_iid
        tr_gates.append(dict(kind=kind, aux=aux, seg=s, args=sem_args,
                             out_interval=out_iid, g=g))
        tr_seg_events[s].append(("gate", g))
        stream.append(("gate", kind, out_slot, locs, aux))
        t = len(stream) - 1
        if out != top_index and next_use(out, g + 1) == _INF:
            free.append((resident.pop(out), t))
            tr_intervals[tr_cur.pop(out)]["end"] = ("death",)
        else:
            heapq.heappush(heap, (-next_use(out, g + 1), out))
    brs_seg_end.append(len(brs_cols))
    for iid in tr_cur.values():
        if tr_intervals[iid]["end"] is None:
            tr_intervals[iid]["end"] = ("death",)

    if top_index not in resident:   # pragma: no cover - defensive
        raise LogicError("replay schedule lost the top value")
    top_slot = resident[top_index]
    n_evicted = E
    scratch_rows = P + max(n_evicted, 1)

    # ---- segment-aligned stream layouts ----------------------------
    # Pad each segment's basic-stream region to a chunk multiple so no
    # chunk straddles a boundary; remap positions accordingly.
    seg_starts = [0] + brs_seg_end[:-1]
    pad_cols: list[int] = []
    pos_offset: list[int] = []   # per segment: padded start - raw start
    acc = 0
    for si in range(n_segs):
        pos_offset.append(acc)
        raw_len = brs_seg_end[si] - seg_starts[si]
        pad = (-raw_len) % brs_chunk
        acc += pad
        pad_cols.append((brs_seg_end[si], pad))
    brs_cols_arr = np.zeros(len(brs_cols) + acc, dtype=np.int64)
    w = 0
    r = 0
    for si in range(n_segs):
        raw_len = brs_seg_end[si] - seg_starts[si]
        brs_cols_arr[w:w + raw_len] = brs_cols[r:r + raw_len]
        w += raw_len
        pad = pad_cols[si][1]
        w += pad           # padding positions read column 0 (zeros OK)
        r += raw_len
    if len(brs_cols_arr) == 0 and res_pad == 0:
        # pragma: no cover - n_basic>0 implies reads>0
        brs_cols_arr = np.zeros(brs_chunk, dtype=np.int64)
    # The resident block rides as a chunk-aligned PREFIX of every
    # trial-tile's staged rows (one gather stages both tiers), so the
    # stream's chunk ids simply shift by res_pad // brs_chunk.
    brs_cols_arr = np.concatenate([res_cols, brs_cols_arr])
    brs_len_pad = len(brs_cols_arr)

    def brs_resolve(pos: int, si: int) -> tuple[int, int, int]:
        p = pos + pos_offset[si] + res_pad
        chunk = p // brs_chunk
        return chunk, chunk % brs_bufs, p % brs_chunk

    grs_rows_pad: list[np.ndarray] = []
    grs_len: list[int] = []
    grs_len_pad: list[int] = []
    for si in range(n_segs):
        rows = grs_rows[si]
        pad = (-len(rows)) % grs_chunk
        arr = np.asarray(rows + [0] * pad, dtype=np.int64)
        grs_rows_pad.append(arr)
        grs_len.append(len(rows))
        grs_len_pad.append(len(arr))

    def grs_resolve(pos: int) -> tuple[int, int, int]:
        chunk = pos // grs_chunk
        return chunk, chunk % grs_bufs, pos % grs_chunk

    # ---- pass B: emission ------------------------------------------
    # Collect per-segment chunk usage from the stream: a ring chunk's
    # DMA starts when its blocker buffer frees (the chunk n_bufs back
    # finishes its last read) and is waited right before its first read.
    seg_events: list[dict] = []
    cur = None
    for t, ev in enumerate(stream):
        if ev[0] == "seg_begin":
            cur = dict(si=ev[1], begin=t, bfirst={}, blast={},
                       gfirst={}, glast={})
            seg_events.append(cur)
        elif ev[0] == "gate":
            for (loc, _flag) in ev[3]:
                if loc[0] == "brs":
                    c, _buf, _off = brs_resolve(loc[1], cur["si"])
                    cur["bfirst"].setdefault(c, t)
                    cur["blast"][c] = t
                elif loc[0] == "grs":
                    c, _buf, _off = grs_resolve(loc[2])
                    cur["gfirst"].setdefault(c, t)
                    cur["glast"][c] = t

    bstarts_at: dict[int, list[int]] = {}
    bwaits_at: dict[int, list[int]] = {}
    gstarts_at: dict[int, list[int]] = {}
    gwaits_at: dict[int, list[int]] = {}
    for se in seg_events:
        bchunks = sorted(se["bfirst"])
        for rank, c in enumerate(bchunks):
            if rank < brs_bufs:
                at = se["begin"]
            else:
                at = se["blast"][bchunks[rank - brs_bufs]] + 1
            bstarts_at.setdefault(at, []).append(c)
            bwaits_at.setdefault(se["bfirst"][c], []).append(c)
        gchunks = sorted(se["gfirst"])
        for rank, c in enumerate(gchunks):
            if rank < grs_bufs:
                at = se["begin"]
            else:
                at = se["glast"][gchunks[rank - grs_bufs]] + 1
            gstarts_at.setdefault(at, []).append(c)
            gwaits_at.setdefault(se["gfirst"][c], []).append(c)

    # Refill start times (hoisted, FIFO per semaphore).
    for t, ev in enumerate(stream):
        if ev[0] == "refill":
            ev[1]["consume_time"] = t
    starts_at_time: dict[int, list[dict]] = {}
    for rec in refills:
        t0 = max(rec["free_time"] + 1, rec["barrier_time"] + 1,
                 rec["evict_time"] + 1,
                 rec["consume_time"] - hoist_events)
        starts_at_time.setdefault(t0, []).append(rec)

    segments: list[list] = []
    ops: list = []
    # Slab flush bookkeeping: eviction e lives at slab buffer
    # (e//S)%R offset e%S and scratch row P+e; flushes cover contiguous
    # eviction ranges within one buffer occupancy.
    S, R = slab_tiles, slab_bufs
    flushed_upto = 0          # evictions [0, flushed_upto) have started
    waited_upto = 0           # flush batches waited up to this eviction
    open_flushes: deque = deque()   # (e0, e1, sem, buf)
    flush_count = 0
    evict_count = 0
    sem_free = [True] * n_refill_sems
    start_queue: list[dict] = []
    sem_fifo = [deque() for _ in range(n_refill_sems)]
    for rec in refills:
        sem_fifo[rec["k"] % n_refill_sems].append(rec["k"])

    def flush_range(e0, e1):
        """Start flushes covering evictions [e0, e1) (may span buffer
        boundaries — one fstart per buffer-contiguous piece)."""
        nonlocal flushed_upto, flush_count
        e = e0
        while e < e1:
            buf = (e // S) % R
            end_of_buf = (e // S + 1) * S
            piece_end = min(e1, end_of_buf)
            sem = flush_count % n_flush_sems
            flush_count += 1
            # FIFO per flush sem: wait any open batch on this sem.
            for fb in [f for f in open_flushes if f[2] == sem]:
                wait_flush(fb)
            ops.append(("fstart", buf, e % S, piece_end - e, P + e, sem))
            open_flushes.append((e, piece_end, sem, buf))
            e = piece_end
        flushed_upto = max(flushed_upto, e1)

    def wait_flush(fb):
        nonlocal waited_upto
        if fb not in open_flushes:
            return
        e0, e1, sem, buf = fb
        ops.append(("fwait", buf, e0 % S, e1 - e0, P + e0, sem))
        open_flushes.remove(fb)
        waited_upto = max(waited_upto, e1)

    def ensure_flushed_through(e):
        """Eviction row e must be readable from scratch."""
        if e >= flushed_upto:
            flush_range(flushed_upto, e + 1)
        for fb in [f for f in list(open_flushes) if f[0] <= e]:
            wait_flush(fb)

    def emit_rstart(rec):
        ensure_flushed_through(rec["row"] - P)
        sem = rec["k"] % n_refill_sems
        assert sem_fifo[sem][0] == rec["k"], "refill sem FIFO violated"
        sem_fifo[sem].popleft()
        ops.append(("rstart", rec["row"], rec["slot"], sem))
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

    cur_si = 0
    for t, ev in enumerate(stream):
        tag = ev[0]
        if tag == "seg_begin":
            # Close the previous segment BEFORE emitting ring events
            # keyed at this index — they belong to the new segment.
            if ops:
                segments.append(ops)
                ops = []
            cur_si = ev[1]
            if res_pad:
                # Resident-basic block load (VMEM does not survive the
                # segment's pallas_call): one sequential chunk DMA of
                # the staged prefix, landed before any gate runs.
                ops.append(("rlstart",))
                ops.append(("rlwait",))
        for c in bstarts_at.get(t, ()):
            ops.append(("bstart", c, c % brs_bufs))
        for c in gstarts_at.get(t, ()):
            ops.append(("gstart", c, c % grs_bufs))
        for c in bwaits_at.get(t, ()):
            ops.append(("bwait", c, c % brs_bufs))
        for c in gwaits_at.get(t, ()):
            ops.append(("gwait", c, c % grs_bufs))
        for rec in starts_at_time.get(t, ()):
            start_queue.append(rec)
        drain_start_queue()
        if tag == "seg_begin":
            pass
        elif tag == "load":
            ops.append(("lstart",))
            ops.append(("lwait",))
        elif tag == "dump":
            # Land everything: slab flushes and outstanding refills are
            # all intra-segment; consumers precede the boundary for
            # refills, and the next segment's gather may read any row.
            flush_range(flushed_upto, evict_count)
            for fb in list(open_flushes):
                wait_flush(fb)
            ops.append(("dstart",))
            ops.append(("dwait",))
        elif tag == "evict":
            _t, slot, e = ev
            buf = (e // S) % R
            if e % S == 0 and e >= R * S:
                # Buffer reuse: its previous occupancy must be flushed
                # and the flush completed before the first overwrite.
                prev_e1 = (e // S - R + 1) * S
                if flushed_upto < prev_e1:
                    flush_range(flushed_upto, prev_e1)
                for fb in [f for f in list(open_flushes)
                           if f[3] == buf]:
                    wait_flush(fb)
            ops.append(("evict", slot, buf, e % S))
            evict_count += 1
            # Full buffer: start its flush eagerly (overlaps compute).
            if e % S == S - 1:
                flush_range(flushed_upto, e + 1)
        elif tag == "refill":
            rec = ev[1]
            if not rec.get("started"):
                if rec in start_queue:
                    start_queue.remove(rec)
                emit_rstart(rec)
            ops.append(("rwait", rec["row"], rec["slot"], rec["sem"]))
            sem_free[rec["sem"]] = True
            drain_start_queue()
        else:  # ("gate", kind, out_slot, locs, aux)
            _tag, kind, out_slot, locs, aux = ev
            rlocs = []
            for loc, flag in locs:
                if loc[0] == "brs":
                    _c, buf, off = brs_resolve(loc[1], cur_si)
                    rlocs.append((("brs", buf, off), flag))
                elif loc[0] == "grs":
                    _c, buf, off = grs_resolve(loc[2])
                    rlocs.append((("grs", buf, off), flag))
                else:
                    rlocs.append((loc, flag))
            ops.append(("gate", kind, out_slot, rlocs, aux))
    # Final segment: land any in-flight flushes.
    flush_range(flushed_upto, evict_count)
    for fb in list(open_flushes):
        wait_flush(fb)
    segments.append(ops)

    vmem = (P + ring_tiles + res_pad) * _TILE_BYTES
    if vmem > vmem_budget:   # pragma: no cover - sized from the budget
        raise LogicError(
            f"replay schedule needs {vmem} bytes VMEM "
            f"(budget {vmem_budget})")

    trace = dict(
        intervals=tr_intervals, gates=tr_gates, evicts=tr_evicts,
        seg_events=tr_seg_events, brs_seg_end=list(brs_seg_end),
        refills=[dict(k=r["k"], evict_event=r["evict_event"],
                      slot=r["slot"], seg=r["seg"],
                      interval=r["interval"]) for r in refills])
    return ReplayProgram(
        segments=segments, brs_cols=brs_cols_arr,
        brs_len_pad=brs_len_pad, brs_chunk=brs_chunk, brs_bufs=brs_bufs,
        res_tiles=res_pad,
        grs_rows=grs_rows_pad, grs_len=grs_len, grs_len_pad=grs_len_pad,
        grs_chunk=grs_chunk, grs_bufs=grs_bufs, pool_slots=P,
        slab_bufs=R, slab_tiles=S, n_flush_sems=n_flush_sems,
        n_refill_sems=n_refill_sems, scratch_rows=scratch_rows,
        top_slot=top_slot, nnz=nnz, n_ops=n_ops, n_basic=n_b,
        n_house=n_h, n_evicted=n_evicted, n_intra=n_intra,
        n_inter=n_inter, n_slab_reads=n_slab_reads,
        n_resident_reads=n_resident_reads, trace=trace)


# ---------------------------------------------------------------------------
# Host-side reference interpreter (semantics + hazard checking).


def simulate_replay_program(program: ReplayProgram, basic_p: np.ndarray,
                            house: np.ndarray) -> float:
    """Execute a replay program on scalars with async-hazard checking.

    ``basic_p``: (n_basic,) float probabilities for one trial.  Models
    every DMA as (start: snapshot source, wait: commit to destination)
    and asserts the schedule never reads an uncommitted destination,
    rewrites an in-flight source, or reads a slab position past its
    reuse — the ordering bugs interpret-mode Pallas can mask.  Gate
    math runs in float32 with the kernel's reduction order, so the
    result matches the gather engine bit-for-bit.
    """
    f32 = np.float32
    one, two = f32(1.0), f32(2.0)
    basic = np.asarray(basic_p, dtype=f32)
    brs = basic[program.brs_cols]                      # the staged stream
    rbas = np.full(max(program.res_tiles, 1), np.nan, f32)
    pending_r: list[np.ndarray] = []
    bring = np.full((program.brs_bufs, program.brs_chunk), np.nan, f32)
    bring_chunk = [-1] * program.brs_bufs
    pending_b: dict[int, tuple[int, np.ndarray]] = {}
    gring = np.full((program.grs_bufs, program.grs_chunk), np.nan, f32)
    gring_chunk = [-1] * program.grs_bufs
    pending_g: dict[int, tuple[int, np.ndarray]] = {}
    pool = np.full(program.pool_slots, np.nan, f32)
    pool_inflight: set[int] = set()
    slab = np.full((program.slab_bufs, program.slab_tiles), np.nan, f32)
    slab_inflight: set[tuple[int, int]] = set()
    scratch = np.full(program.scratch_rows, np.nan, f32)
    scratch_ready = np.zeros(program.scratch_rows, dtype=bool)
    pending_flush: dict[tuple, np.ndarray] = {}
    pending_refill: dict[tuple, float] = {}
    pending_dump = pending_load = None
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
        if tag == "brs":
            buf, off = loc[1], loc[2]
            assert bring_chunk[buf] >= 0, f"read of unwaited brs buf {buf}"
            assert buf not in pending_b, \
                f"read of brs buf {buf} with an in-flight DMA"
            return bring[buf, off]
        if tag == "grs":
            buf, off = loc[1], loc[2]
            assert gring_chunk[buf] >= 0, f"read of unwaited grs buf {buf}"
            assert buf not in pending_g, \
                f"read of grs buf {buf} with an in-flight DMA"
            return gring[buf, off]
        if tag == "slab":
            v = slab[loc[1], loc[2]]
            assert not np.isnan(v), \
                f"read of undefined slab position {loc[1:]}"
            return v
        if tag == "rbas":
            assert not pending_r, \
                "resident-basic read with the block load in flight"
            v = rbas[loc[1]]
            assert not np.isnan(v), \
                f"read of unloaded resident basic {loc[1]}"
            return v
        return f32(house[loc[1]])

    n_tiles_seen = 0
    top = None
    grs_cur = np.zeros(0, f32)
    for k, ops in enumerate(program.segments):
        if k > 0 and program.grs_len_pad[k]:
            rows = program.grs_rows[k]
            assert scratch_ready[rows].all() or not len(rows), \
                f"segment {k} gathers unwritten scratch rows"
            grs_cur = scratch[rows]
        # Slab does not survive the segment boundary.
        slab[:] = np.nan
        rbas[:] = np.nan              # VMEM dies with the pallas_call
        for op in ops:
            tag = op[0]
            if tag == "rlstart":
                assert not pending_r
                pending_r.append(brs[:program.res_tiles].copy())
            elif tag == "rlwait":
                rbas[:program.res_tiles] = pending_r.pop()
            elif tag == "bstart":
                c, buf = op[1], op[2]
                assert buf not in pending_b, \
                    f"brs start overlaps pending on buf {buf}"
                lo = c * program.brs_chunk
                pending_b[buf] = (c, brs[lo:lo + program.brs_chunk].copy())
            elif tag == "bwait":
                c, buf = op[1], op[2]
                pc, data = pending_b.pop(buf)
                assert pc == c, f"brs wait mismatch: {pc} != {c}"
                bring[buf, :len(data)] = data
                bring_chunk[buf] = c
            elif tag == "gstart":
                c, buf = op[1], op[2]
                assert buf not in pending_g, \
                    f"grs start overlaps pending on buf {buf}"
                lo = c * program.grs_chunk
                pending_g[buf] = (c,
                                  grs_cur[lo:lo + program.grs_chunk].copy())
            elif tag == "gwait":
                c, buf = op[1], op[2]
                pc, data = pending_g.pop(buf)
                assert pc == c, f"grs wait mismatch: {pc} != {c}"
                gring[buf, :len(data)] = data
                gring_chunk[buf] = c
            elif tag == "evict":
                slot, sbuf, soff = op[1], op[2], op[3]
                assert (sbuf, soff) not in slab_inflight, \
                    "evict rewrites an in-flight slab tile"
                assert slot not in pool_inflight
                assert not np.isnan(pool[slot]), "evict of undefined slot"
                slab[sbuf, soff] = pool[slot]
            elif tag == "fstart":
                _t, sbuf, off0, n, row0, sem = op
                assert sem not in flush_sem_busy, \
                    f"flush sem {sem} reused while pending"
                key = (sbuf, off0, n, row0, sem)
                data = slab[sbuf, off0:off0 + n].copy()
                assert not np.isnan(data).any(), \
                    f"flush of unwritten slab range {key}"
                pending_flush[key] = data
                for i in range(n):
                    slab_inflight.add((sbuf, off0 + i))
                flush_sem_busy[sem] = 1
            elif tag == "fwait":
                _t, sbuf, off0, n, row0, sem = op
                key = (sbuf, off0, n, row0, sem)
                data = pending_flush.pop(key)
                scratch[row0:row0 + n] = data
                scratch_ready[row0:row0 + n] = True
                for i in range(n):
                    slab_inflight.discard((sbuf, off0 + i))
                del flush_sem_busy[sem]
            elif tag == "rstart":
                _t, row, slot, sem = op
                assert sem not in refill_sem_busy, \
                    f"refill sem {sem} reused while pending"
                assert scratch_ready[row], \
                    f"refill reads unflushed scratch row {row}"
                pending_refill[(row, slot, sem)] = scratch[row]
                pool_inflight.add(slot)
                refill_sem_busy[sem] = 1
            elif tag == "rwait":
                _t, row, slot, sem = op
                value = pending_refill.pop((row, slot, sem))
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
                assert not pending_refill and pending_dump is None
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
                        for j in range(1, cap):
                            new.append(dp[j] * (one - v) + dp[j - 1] * v)
                        new.append(dp[cap] + dp[cap - 1] * v)
                        dp = new[:cap] + [new[cap]]
                    value = f32(sum(dp[j] for j in range(lo, hi + 1)))
                pool[out_slot] = value
        assert not pending_b and not pending_g and not pending_r, \
            "stream DMA crosses a segment boundary"
        assert not pending_flush, "flush DMA crosses a segment boundary"
        assert not pending_refill, "refill DMA crosses a segment boundary"
        assert pending_dump is None and pending_load is None
        n_tiles_seen += 1
        top = pool[program.top_slot]
    return float(top)
