"""Adjoint (reverse-mode) schedule for the replay-stream engine.

``compiler/adjoint.py`` gives the plain stream engine a kernel-speed
backward pass, but trees that thrash the VMEM pool — exactly the scale
that motivates importance analysis — fell back to the gather engine's
autodiff.  This module compiles a :class:`~.replay.ReplayProgram` into
forward-with-tape and segment-reversed backward op lists, extending the
tape discipline to the replay engine's evicted-value traffic:

* **Forward tape**: every gate's argument tiles are copied (from
  whatever location the forward reads them: pool, basic stream, gate
  stream, slab) into a double-buffered VMEM slab flushing to an HBM
  tape in read order — the backward's only value source, so it needs
  none of the forward's eviction machinery re-run.
* **Slot-mirrored adjoint pool, per residency interval**: a value's
  pool-residency intervals (def->evict, refill->evict/death) are
  disjoint in forward time, so their adjoint accumulations are disjoint
  in backward time and reuse the forward slot assignment verbatim.
* **Cotangent streams mirror every forward stream.**  Each basic-stream
  read's cotangent is written once into a reversed *gradient stream*
  with the same layout as the basic replay stream (the transpose of the
  staging gather — an XLA scatter-add finishes the basic gradient);
  each gate-stream read's cotangent goes to a per-segment stream that
  is scatter-added into an *adjoint log* (one row per eviction event)
  between segment kernels.
* **Reversed evictions inject accumulated adjoints.**  A backward
  segment reads its eviction range of the adjoint log in descending
  order — sequential, so it streams through a ring like everything
  else — and at each reversed eviction stores ``log[e] (+ the adjoint
  slab mirror for short-arc reads) (+ side-buffer transfers from
  reversed intra-segment refills)`` into the value's slot.
* The adjoint pool itself dumps/loads across backward segment
  boundaries exactly like the forward pool.

The result: the backward pass is sequential-stream-bound like the
forward — no scattered DMA beyond the forward's own intra-refill count.

Everything here is host-side scheduling; ``simulate_replay_adjoint``
executes both op lists on scalars with async-DMA hazard checking (the
methodology that validates every kernel schedule in this codebase).

Reference anchor: importance analysis is a first-class Settings
capability (``reference/src/mef/openpsa/settings.h:262-278``);
the reference never built its engine, let alone an adjoint of it at
spill scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import LogicError
from .replay import ReplayProgram, build_replay_schedule
from .schedule import _TILE_BYTES, _VMEM_BUDGET

__all__ = ["ReplayAdjointProgram", "build_replay_adjoint",
           "simulate_replay_adjoint"]

#: Leave-one-out DP width guard (as in compiler/adjoint.py).
_MAX_COUNT_BWD_OPS = 4096


@dataclasses.dataclass
class ReplayAdjointProgram:
    """Forward-with-tape + per-segment backward op lists.

    ``fwd_segments[k]`` extends the replay grammar with:

    - ``("tput", loc, slab_buf, slab_off)`` — copy the value at ``loc``
      (any forward read loc) into the tape slab.
    - ``("tfstart"/"tfwait", slab_buf, n, row0)`` — flush slab rows
      ``[0, n)`` to tape rows ``[row0, row0+n)``.

    ``bwd_segments[k]`` is a LIST of sub-kernel op lists (executed for
    k = n_segs-1 .. 0, sub-kernels in list order): each sub-kernel is
    one ``pallas_call`` of at most ``max_bwd_ops`` estimated tile ops
    (host tracing of straight-line kernels is superlinear in kernel
    size), with the adjoint pool crossing sub-kernel boundaries through
    the adjoint scratch (``lstart``/``dstart``).  Sub-kernel grammar:

    - ``("binit",)`` — adjoint of the top slot := cotangent.
    - ``("lstart"/"lwait")`` / ``("dstart"/"dwait")`` — adjoint pool
      load/dump against the adjoint scratch rows ``[0, pool_slots)``.
    - ``("tstart"/"twait", row0, n, buf)`` — tape ring chunk (rows
      descending).
    - ``("istart"/"iwait", row0, n, buf)`` — adjoint-log injection ring
      chunk (adjoint scratch rows ``[P+row0, P+row0+n)``, descending).
    - ``("gczero", buf)`` / ``("gcstart"/"gcwait", chunk, buf)`` —
      gradient-stream ring buffer zero / flush to gradient rows
      ``[chunk*brs_chunk, +brs_chunk)``.
    - ``("iczero", buf)`` / ``("icstart"/"icwait", chunk, buf)`` — the
      same for this segment's gate-stream cotangent output.
    - ``("rside", idx, slot)`` — side buffer := adjoint pool slot
      (reversed intra-segment refill).
    - ``("bevict", slot, inj, slab, sides)`` — reversed eviction:
      ``adj[slot] := inj? ibuf[buf][off] + slab? aslab[sbuf][soff]
      + sum(side[idx])`` (each term optional; all-None stores zero).
    - ``("bgate", kind, out_slot, bargs, aux)`` — propagate the adjoint
      in ``out_slot``; ``bargs`` = ``(vloc, gloc, neg)`` with ``vloc``
      ``("tape", buf, off)`` / ``("house", pos)`` and ``gloc``
      ``("apool", slot, first)`` / ``("aslab", sbuf, soff, first)`` /
      ``("gcot", buf, off)`` / ``("icot", buf, off)`` / ``None``.
    """

    base: ReplayProgram
    fwd_segments: list
    bwd_segments: list
    tape_rows: int                 # total, chunk-aligned per segment
    tape_seg_start: list
    tct: int
    tape_bufs: int
    tape_slab: int
    gcot_bufs: int
    icot_bufs: int
    inj_chunk: int
    inj_bufs: int
    side_cap: int
    adj_rows: int                  # adjoint scratch rows: P + n_evicted
    max_bwd_ops: int = 12288       # estimated tile-op cap per sub-kernel

    @property
    def bwd_vmem_bytes(self) -> int:
        b = self.base
        return (b.pool_slots + self.tape_bufs * self.tct
                + self.gcot_bufs * b.brs_chunk
                + self.icot_bufs * b.grs_chunk
                + self.inj_bufs * self.inj_chunk
                + b.slab_bufs * b.slab_tiles + self.side_cap) * _TILE_BYTES


def build_replay_adjoint(tree, tct: int = 128, tape_bufs: int = 3,
                         tape_slab: int = 128, gcot_bufs: int = 2,
                         icot_bufs: int = 2, inj_chunk: int = 64,
                         inj_bufs: int = 2, side_cap: int = 128,
                         vmem_budget: int = _VMEM_BUDGET,
                         max_bwd_ops: int = 12288,
                         **replay_kwargs) -> ReplayAdjointProgram:
    """Build forward and adjoint replay schedules for ``tree``.

    The forward pool is sized so that both the taped forward kernel and
    the backward kernel fit the VMEM budget.  Raises
    :class:`LogicError` when no valid schedule exists (callers fall
    back to the gather engine's autodiff).
    """
    budget_tiles = vmem_budget // _TILE_BYTES
    brs_chunk = replay_kwargs.get("brs_chunk", 256)
    brs_bufs = replay_kwargs.get("brs_bufs", 3)
    grs_chunk = replay_kwargs.get("grs_chunk", 128)
    grs_bufs = replay_kwargs.get("grs_bufs", 2)
    slab_bufs = replay_kwargs.get("slab_bufs", 4)
    slab_tiles = replay_kwargs.get("slab_tiles", 64)
    fwd_extra = (brs_bufs * brs_chunk + grs_bufs * grs_chunk
                 + slab_bufs * slab_tiles + 2 * tape_slab)
    bwd_extra = (tape_bufs * tct + gcot_bufs * brs_chunk
                 + icot_bufs * grs_chunk + inj_bufs * inj_chunk
                 + slab_bufs * slab_tiles + side_cap)
    if "pool_slots" not in replay_kwargs:
        pool = budget_tiles - max(fwd_extra, bwd_extra)
        if pool < 2:
            raise LogicError("replay adjoint: rings exhaust the VMEM "
                             "budget")
        replay_kwargs["pool_slots"] = pool
    # The adjoint tapes every argument read, so the hybrid
    # resident-basic tier buys nothing on this path — force it off (the
    # backward has no cotangent route for ("rbas", ...) reads).
    replay_kwargs["resident_tiles"] = 0
    program = build_replay_schedule(tree, **replay_kwargs)
    return _build_adjoint(program, tct, tape_bufs, tape_slab, gcot_bufs,
                          icot_bufs, inj_chunk, inj_bufs, side_cap,
                          vmem_budget, max_bwd_ops)


def _ring_schedule(core, uses_of, n_bufs, descending=True, base=0):
    """Generic ring-event scheduler over a core op list.

    ``uses_of``: chunk -> sorted list of core-op indices using it.
    Returns (starts_at, waits_at): core index -> [chunk, ...], with
    chunk c's DMA started after the last use of the chunk ``n_bufs``
    positions earlier in consumption order (or at index ``base`` — the
    first position of the sub-kernel being scheduled).
    """
    order = sorted(uses_of, reverse=descending)
    starts: dict[int, list[int]] = {}
    waits: dict[int, list[int]] = {}
    for rank, c in enumerate(order):
        if rank < n_bufs:
            at = base
        else:
            at = uses_of[order[rank - n_bufs]][-1] + 1
        first = uses_of[c][0]
        if at > first:
            raise LogicError(
                "replay adjoint: ring window too narrow for a gate's "
                "argument block — use the gather engine for gradients")
        starts.setdefault(at, []).append(c)
        waits.setdefault(first, []).append(c)
    return starts, waits


def _build_adjoint(program: ReplayProgram, tct, tape_bufs, tape_slab,
                   gcot_bufs, icot_bufs, inj_chunk, inj_bufs, side_cap,
                   vmem_budget,
                   max_bwd_ops: int = 12288) -> ReplayAdjointProgram:
    if program.trace is None:
        raise LogicError("replay adjoint needs a program with a trace")
    if program.res_tiles:
        raise LogicError("replay adjoint: build the base program with "
                         "resident_tiles=0 (rbas reads have no "
                         "cotangent route)")
    tr = program.trace
    intervals, gates = tr["intervals"], tr["gates"]
    P = program.pool_slots
    n_segs = len(program.segments)

    # Ring-window guards: a single gate's argument block must fit the
    # backward stream windows (tape rows / cotangent chunks are
    # consecutive per gate).
    max_fanin = max((len(rec["args"]) for rec in gates), default=0)
    if max_fanin >= (tape_bufs - 1) * tct:
        raise LogicError(
            f"replay adjoint: fan-in {max_fanin} exceeds the tape ring "
            f"window ({tape_bufs}x{tct})")
    if max_fanin >= (gcot_bufs - 1) * program.brs_chunk:
        raise LogicError(
            f"replay adjoint: fan-in {max_fanin} exceeds the gradient "
            f"stream window ({gcot_bufs}x{program.brs_chunk})")
    if max_fanin >= (icot_bufs - 1) * program.grs_chunk:
        raise LogicError(
            f"replay adjoint: fan-in {max_fanin} exceeds the cotangent "
            f"stream window ({icot_bufs}x{program.grs_chunk})")

    # Count-gate backward width guard.
    for rec in gates:
        if rec["kind"] == "count":
            F = len(rec["args"])
            if F * (F - 1) * (rec["aux"][1] + 1) > _MAX_COUNT_BWD_OPS:
                raise LogicError(
                    f"replay adjoint: count gate of fan-in {F} exceeds "
                    "the leave-one-out unroll guard — use the gather "
                    "engine for gradients")

    # brs raw->padded position mapping (mirror of the forward layout).
    brs_seg_end = tr["brs_seg_end"]
    seg_starts = [0] + brs_seg_end[:-1]
    pos_offset, acc = [], 0
    for si in range(n_segs):
        pos_offset.append(acc)
        acc += (-(brs_seg_end[si] - seg_starts[si])) % program.brs_chunk

    def brs_padded(pos, si):
        return pos + pos_offset[si]

    # First-backward-touch tokens (store-vs-accumulate) per interval /
    # eviction.  The backward visits gates in descending g and a gate's
    # args in ascending ai, so the first touch is the read with the
    # highest g and, within it, the LOWEST ai (a gate can read the same
    # value twice).
    def _bwd_first(tokens):
        return max(tokens, key=lambda t: (t[0], -t[1]))

    pool_reads_of = {}        # interval id -> [(g, ai), ...]
    slab_reads_of = {}        # eviction e -> [(g, ai), ...]
    for rec in gates:
        g = rec["g"]
        for ai, (loc, _f) in enumerate(rec["args"]):
            if loc[0] == "pool":
                pool_reads_of.setdefault(loc[1], []).append((g, ai))
            elif loc[0] == "slab":
                slab_reads_of.setdefault(loc[1], []).append((g, ai))
    last_pool_read = {i: _bwd_first(v) for i, v in pool_reads_of.items()}
    last_slab_read = {e: _bwd_first(v) for e, v in slab_reads_of.items()}

    # Which evictions receive gate-stream (inter-segment) cotangents.
    has_inj = set()
    for si in range(n_segs):
        rows = program.grs_rows[si][:program.grs_len[si]]
        for r in rows:
            has_inj.add(int(r) - P)

    # Refills grouped by the eviction event they read.
    refs_of_evict: dict[int, list[int]] = {}
    refill_by_k = {}
    for rec in tr["refills"]:
        refs_of_evict.setdefault(rec["evict_event"], []).append(rec["k"])
        refill_by_k[rec["k"]] = rec
    evict_by_e = {i: rec for i, rec in enumerate(tr["evicts"])}

    # ---- forward pass: replay ops + tape puts -----------------------
    fwd_segments = []
    tape_pos = {}                    # (g, ai) -> tape row
    tape_seg_start = []
    next_row = 0
    gi = 0                           # global gate counter (exec order)
    for k, seg in enumerate(program.segments):
        tape_seg_start.append(next_row)
        ops = []
        sbuf, soff, batch_row0 = 0, 0, next_row
        slab_pending = [None, None]

        def flush(final=False):
            nonlocal sbuf, soff, batch_row0
            if soff:
                ops.append(("tfstart", sbuf, soff, batch_row0))
                slab_pending[sbuf] = (soff, batch_row0)
            if final:
                for b in (0, 1):
                    if slab_pending[b] is not None:
                        n, r0 = slab_pending[b]
                        ops.append(("tfwait", b, n, r0))
                        slab_pending[b] = None
                return
            sbuf ^= 1
            soff = 0
            batch_row0 = next_row
            if slab_pending[sbuf] is not None:
                n, r0 = slab_pending[sbuf]
                ops.append(("tfwait", sbuf, n, r0))
                slab_pending[sbuf] = None

        for op in seg:
            if op[0] == "gate":
                _t, kind, out_slot, locs, aux = op
                for ai, (loc, _f) in enumerate(locs):
                    if loc[0] == "house":
                        continue
                    if soff == tape_slab:
                        flush()
                    ops.append(("tput", loc, sbuf, soff))
                    tape_pos[(gi, ai)] = next_row
                    soff += 1
                    next_row += 1
                gi += 1
            ops.append(op)
        flush(final=True)
        next_row += (-next_row) % tct        # segment-align tape chunks
        fwd_segments.append(ops)
    tape_rows = max(next_row, tct)
    if not tape_pos:
        raise LogicError("replay adjoint: nothing to differentiate")

    # tape_pos keys are (exec-order gate counter, ai); gates records use
    # the same ordering (g == index).  Map (g, ai) directly.

    # ---- backward pass per segment, split into sub-kernels ----------
    # A backward segment's unrolled tile-op count is ~6-8x its forward
    # gate count (leave-one-out partials), and host tracing of
    # straight-line Pallas programs is superlinear in per-kernel size
    # (the 65k tree's one-kernel-per-segment backward traced 45+ min —
    # the ~15k-op wall).  Each segment's reversed-event core is
    # therefore CUT into sub-kernels of at most ``max_bwd_ops``
    # estimated tile ops, at boundaries where no VMEM state is live
    # except the adjoint pool — which crosses through the adjoint
    # scratch via the same dump/load the forward pool uses.  Live state
    # that pins a boundary: an adjoint-slab mirror between its first
    # cotangent write and its reversed eviction, a side buffer between
    # ``rside`` and its ``bevict``, and a partially written gcot/icot
    # chunk.  Tape / injection ring chunks straddling a cut are simply
    # re-read by the next sub-kernel.
    bwd_segments = []
    n_evict = program.n_evicted
    for k in range(n_segs):
        events = tr["seg_events"][k]
        # Segment eviction range for the injection stream.
        seg_evicts = [e for tag, e in events if tag == "evict"]
        e_lo = min(seg_evicts) if seg_evicts else 0
        e_hi = max(seg_evicts) + 1 if seg_evicts else 0

        # Core ops (reversed event order), with per-op ring uses, an
        # estimated unrolled-tile-op cost, and boundary-pinning spans.
        core = []
        cost: list[int] = []
        tape_uses: dict[int, list[int]] = {}
        inj_uses: dict[int, list[int]] = {}
        gcot_uses: dict[int, list[int]] = {}
        icot_uses: dict[int, list[int]] = {}
        side_idx_of: dict[int, int] = {}
        side_pos: dict[int, int] = {}
        aslab_start: dict[int, int] = {}
        live_spans: list[tuple[int, int]] = []
        n_side = 0

        def inj_loc(e):
            # Chunk j covers adjoint-log rows [e_hi-(j+1)*IC, e_hi-j*IC)
            # clipped to the segment's eviction range.
            j = (e_hi - 1 - e) // inj_chunk
            lo = max(e_hi - (j + 1) * inj_chunk, e_lo)
            return j, e - lo

        for tag, x in reversed(events):
            pos_i = len(core)
            if tag == "refill":
                rec = refill_by_k[x]
                if n_side >= side_cap:
                    raise LogicError(
                        "replay adjoint: intra-refill side buffer "
                        f"overflow ({side_cap}) — use the gather engine")
                side_idx_of[x] = n_side
                side_pos[x] = pos_i
                core.append(("rside", n_side, rec["slot"]))
                cost.append(2)
                n_side += 1
            elif tag == "evict":
                ev = evict_by_e[x]
                inj = None
                if x in has_inj:
                    j, off = inj_loc(x)
                    inj = (j, off)       # buffer resolved per sub-kernel
                    inj_uses.setdefault(j, []).append(pos_i)
                slab = None
                if x in slab_reads_of:
                    slab = ((x // program.slab_tiles) % program.slab_bufs,
                            x % program.slab_tiles)
                    live_spans.append((aslab_start[x], pos_i))
                sides = [side_idx_of[kk] for kk in refs_of_evict.get(x, ())
                         if kk in side_idx_of]
                for kk in refs_of_evict.get(x, ()):
                    if kk in side_pos:
                        live_spans.append((side_pos[kk], pos_i))
                core.append(("bevict", ev["slot"], inj, slab, sides))
                cost.append(2 + len(sides))
            else:  # gate
                rec = gates[x]
                bargs = []
                for ai, (loc, flag) in enumerate(rec["args"]):
                    if loc[0] == "house":
                        bargs.append((loc, None, flag))
                        continue
                    row = tape_pos[(x, ai)]
                    tc = row // tct
                    vloc = ("tape", tc % tape_bufs, row % tct)
                    tape_uses.setdefault(tc, []).append(pos_i)
                    if loc[0] == "pool":
                        iid = loc[1]
                        first = (intervals[iid]["end"] == ("death",)
                                 and last_pool_read[iid] == (x, ai))
                        gloc = ("apool", intervals[iid]["slot"], first)
                    elif loc[0] == "slab":
                        e = loc[1]
                        first = last_slab_read[e] == (x, ai)
                        aslab_start.setdefault(e, pos_i)
                        gloc = ("aslab",
                                (e // program.slab_tiles)
                                % program.slab_bufs,
                                e % program.slab_tiles, first)
                    elif loc[0] == "grs":
                        _t, _s, pos = loc
                        c = pos // program.grs_chunk
                        icot_uses.setdefault(c, []).append(pos_i)
                        gloc = ("icot", c, pos % program.grs_chunk)
                    else:  # brs
                        p = brs_padded(loc[1], k)
                        c = p // program.brs_chunk
                        gcot_uses.setdefault(c, []).append(pos_i)
                        gloc = ("gcot", c, p % program.brs_chunk)
                    bargs.append((vloc, gloc, flag))
                out_iid = rec["out_interval"]
                core.append(("bgate", rec["kind"],
                             intervals[out_iid]["slot"], bargs,
                             rec["aux"]))
                F = len(rec["args"])
                if rec["kind"] == "count":
                    cost.append(F * (F - 1) * (rec["aux"][1] + 1)
                                + 4 * F)
                else:
                    cost.append(8 * F + 6)

        for uses in (tape_uses, inj_uses, gcot_uses, icot_uses):
            for v in uses.values():
                v.sort()
        for us in list(gcot_uses.values()) + list(icot_uses.values()):
            live_spans.append((us[0], us[-1]))

        # Valid cut positions + greedy sub-kernel selection: accumulate
        # estimated cost; once past the budget, cut at the latest valid
        # boundary seen (overrunning only when no boundary exists yet —
        # a pinned span longer than the budget).
        n_core = len(core)
        invalid = np.zeros(n_core + 1, dtype=bool)
        for s, e in live_spans:
            invalid[s + 1:e + 1] = True
        cuts = [0]
        lo_c = 0
        while lo_c < n_core:
            acc = 0
            p = lo_c
            best = None
            cut_made = False
            while p < n_core:
                acc += cost[p]
                p += 1
                if not invalid[p]:
                    best = p
                if acc >= max_bwd_ops and best is not None \
                        and best > lo_c:
                    cuts.append(best)
                    lo_c = best
                    cut_made = True
                    break
            if not cut_made:
                cuts.append(n_core)
                lo_c = n_core

        # Write-stream rings (gcot/icot): zero+start-of-use before the
        # first write of a chunk, flush after its last write; the
        # buffer's previous occupant (n_bufs later in descending order)
        # must have flushed first.
        def wstream_events(uses, n_bufs):
            order = sorted(uses, reverse=True)
            zero_at: dict[int, list[int]] = {}
            fstart_at: dict[int, list[int]] = {}
            fwait_before_zero: dict[int, int] = {}
            for rank, c in enumerate(order):
                zero_at.setdefault(uses[c][0], []).append(c)
                fstart_at.setdefault(uses[c][-1] + 1, []).append(c)
                if rank >= n_bufs:
                    fwait_before_zero[c] = order[rank - n_bufs]
            return order, zero_at, fstart_at, fwait_before_zero

        def emit_sub(lo, hi, first_kernel, last_kernel):
            """Emit the op list for core positions [lo, hi)."""
            def in_range(uses):
                out = {}
                for c, us in uses.items():
                    sub = [u for u in us if lo <= u < hi]
                    if sub:
                        out[c] = sub
                return out

            sub_tape = in_range(tape_uses)
            sub_inj = in_range(inj_uses)
            sub_gcot = in_range(gcot_uses)
            sub_icot = in_range(icot_uses)
            t_starts, t_waits = _ring_schedule(core, sub_tape, tape_bufs,
                                               base=lo)
            # Injection chunk ids ascend in consumption order (chunk 0
            # covers the highest adjoint-log rows, read first) and may
            # be SPARSE, so buffers go by consumption rank, not id.
            i_starts, i_waits = _ring_schedule(core, sub_inj, inj_bufs,
                                               descending=False, base=lo)
            inj_buf_of = {c: r % inj_bufs
                          for r, c in enumerate(sorted(sub_inj))}
            g_order, g_zero, g_fstart, g_fwait = wstream_events(
                sub_gcot, gcot_bufs)
            i_order, i_zero, i_fstart, i_fwait = wstream_events(
                sub_icot, icot_bufs)

            ops = []
            if first_kernel:
                ops.append(("binit",))
            else:
                ops.append(("lstart",))
                ops.append(("lwait",))
            gc_flushed: set[int] = set()
            ic_flushed: set[int] = set()
            gc_waited: set[int] = set()
            ic_waited: set[int] = set()
            for pos_i in range(lo, hi + 1):
                for c in g_fstart.get(pos_i, ()):
                    ops.append(("gcstart", c, c % gcot_bufs))
                    gc_flushed.add(c)
                for c in i_fstart.get(pos_i, ()):
                    ops.append(("icstart", c, c % icot_bufs))
                    ic_flushed.add(c)
                for c in g_zero.get(pos_i, ()):
                    prev = g_fwait.get(c)
                    if prev is not None and prev not in gc_waited:
                        ops.append(("gcwait", prev, prev % gcot_bufs))
                        gc_waited.add(prev)
                    ops.append(("gczero", c % gcot_bufs))
                for c in i_zero.get(pos_i, ()):
                    prev = i_fwait.get(c)
                    if prev is not None and prev not in ic_waited:
                        ops.append(("icwait", prev, prev % icot_bufs))
                        ic_waited.add(prev)
                    ops.append(("iczero", c % icot_bufs))
                for c in t_starts.get(pos_i, ()):
                    row0 = c * tct
                    n = min(tct, tape_rows - row0)
                    ops.append(("tstart", row0, n, c % tape_bufs))
                for c in i_starts.get(pos_i, ()):
                    j = c
                    hi_e = e_hi - j * inj_chunk
                    lo_e = max(hi_e - inj_chunk, e_lo)
                    ops.append(("istart", lo_e, hi_e - lo_e,
                                inj_buf_of[j]))
                for c in t_waits.get(pos_i, ()):
                    row0 = c * tct
                    n = min(tct, tape_rows - row0)
                    ops.append(("twait", row0, n, c % tape_bufs))
                for c in i_waits.get(pos_i, ()):
                    j = c
                    hi_e = e_hi - j * inj_chunk
                    lo_e = max(hi_e - inj_chunk, e_lo)
                    ops.append(("iwait", lo_e, hi_e - lo_e,
                                inj_buf_of[j]))
                if pos_i < hi:
                    op = core[pos_i]
                    if op[0] == "bevict" and op[2] is not None:
                        j, off = op[2]
                        op = (op[0], op[1], (inj_buf_of[j], off),
                              op[3], op[4])
                    ops.append(op)
            # Land all write-stream flushes.
            for c in g_order:
                if c not in gc_flushed:   # pragma: no cover - defensive
                    ops.append(("gcstart", c, c % gcot_bufs))
                if c not in gc_waited:
                    ops.append(("gcwait", c, c % gcot_bufs))
                    gc_waited.add(c)
            for c in i_order:
                if c not in ic_flushed:   # pragma: no cover - defensive
                    ops.append(("icstart", c, c % icot_bufs))
                if c not in ic_waited:
                    ops.append(("icwait", c, c % icot_bufs))
                    ic_waited.add(c)
            if not last_kernel:
                ops.append(("dstart",))
                ops.append(("dwait",))
            return ops

        sub_lists = []
        for si in range(len(cuts) - 1):
            sub_lists.append(emit_sub(
                cuts[si], cuts[si + 1],
                first_kernel=(k == n_segs - 1 and si == 0),
                last_kernel=(k == 0 and si == len(cuts) - 2)))
        if not sub_lists:       # a segment with an empty core
            sub_lists.append(emit_sub(
                0, 0, first_kernel=(k == n_segs - 1),
                last_kernel=(k == 0)))
        bwd_segments.append(sub_lists)

    aprog = ReplayAdjointProgram(
        base=program, fwd_segments=fwd_segments,
        bwd_segments=bwd_segments, tape_rows=tape_rows,
        tape_seg_start=tape_seg_start, tct=tct, tape_bufs=tape_bufs,
        tape_slab=tape_slab, gcot_bufs=gcot_bufs, icot_bufs=icot_bufs,
        inj_chunk=inj_chunk, inj_bufs=inj_bufs, side_cap=side_cap,
        adj_rows=P + max(n_evict, 1), max_bwd_ops=max_bwd_ops)
    if aprog.bwd_vmem_bytes > vmem_budget:
        raise LogicError(
            f"replay adjoint: backward working set "
            f"{aprog.bwd_vmem_bytes} exceeds the VMEM budget "
            f"{vmem_budget}")
    return aprog


# ---------------------------------------------------------------------------
# Host-side scalar reference interpreter with async-hazard checking.


def simulate_replay_adjoint(aprog: ReplayAdjointProgram,
                            basic_p: np.ndarray, house: np.ndarray,
                            ct: float = 1.0):
    """Execute fwd+bwd op lists on scalars with DMA hazard checking.

    Returns ``(top_value, grad_basic)`` for one trial; the forward value
    matches the replay kernel bit-for-bit (f32, same reduction order),
    the gradient is a float64 host reference for the backward schedule.
    """
    from ._scalar_reference import _bgate_partials, _gate_scalar

    prog = aprog.base
    f32 = np.float32
    basic = np.asarray(basic_p, dtype=f32)
    brs = basic[prog.brs_cols]
    bring = np.full((prog.brs_bufs, prog.brs_chunk), np.nan, f32)
    pending_b: dict[int, tuple[int, np.ndarray]] = {}
    gring = np.full((prog.grs_bufs, prog.grs_chunk), np.nan, f32)
    pending_g: dict[int, tuple[int, np.ndarray]] = {}
    pool = np.full(prog.pool_slots, np.nan, f32)
    pool_inflight: set[int] = set()
    slab = np.full((prog.slab_bufs, prog.slab_tiles), np.nan, f32)
    scratch = np.full(prog.scratch_rows, np.nan, f32)
    scratch_ready = np.zeros(prog.scratch_rows, dtype=bool)
    pending_flush: dict[tuple, np.ndarray] = {}
    pending_refill: dict[tuple, float] = {}
    pending_dump = pending_load = None
    tape = np.full(aprog.tape_rows, np.nan, f32)
    tape_ok = np.zeros(aprog.tape_rows, dtype=bool)
    tslab = np.full((2, aprog.tape_slab), np.nan, f32)
    pend_tf: dict[int, tuple[int, int, np.ndarray]] = {}

    def read(loc):
        tag = loc[0]
        if tag == "pool":
            v = pool[loc[1]]
            assert not np.isnan(v), f"undefined pool slot {loc[1]}"
            return v
        if tag == "brs":
            return bring[loc[1], loc[2]]
        if tag == "grs":
            return gring[loc[1], loc[2]]
        if tag == "slab":
            v = slab[loc[1], loc[2]]
            assert not np.isnan(v), "undefined slab read"
            return v
        return f32(house[loc[1]])

    grs_cur = np.zeros(0, f32)
    top = None
    for k, ops in enumerate(aprog.fwd_segments):
        if k > 0 and prog.grs_len_pad[k]:
            rows = prog.grs_rows[k]
            grs_cur = scratch[rows]
        slab[:] = np.nan
        for op in ops:
            tag = op[0]
            if tag == "bstart":
                lo = op[1] * prog.brs_chunk
                pending_b[op[2]] = (op[1],
                                    brs[lo:lo + prog.brs_chunk].copy())
            elif tag == "bwait":
                pc, data = pending_b.pop(op[2])
                assert pc == op[1]
                bring[op[2], :len(data)] = data
            elif tag == "gstart":
                lo = op[1] * prog.grs_chunk
                pending_g[op[2]] = (op[1],
                                    grs_cur[lo:lo + prog.grs_chunk].copy())
            elif tag == "gwait":
                pc, data = pending_g.pop(op[2])
                assert pc == op[1]
                gring[op[2], :len(data)] = data
            elif tag == "evict":
                slab[op[2], op[3]] = pool[op[1]]
            elif tag == "fstart":
                _t, sbuf, off0, n, row0, sem = op
                pending_flush[(sbuf, off0, n, row0, sem)] = \
                    slab[sbuf, off0:off0 + n].copy()
            elif tag == "fwait":
                _t, sbuf, off0, n, row0, sem = op
                data = pending_flush.pop((sbuf, off0, n, row0, sem))
                scratch[row0:row0 + n] = data
                scratch_ready[row0:row0 + n] = True
            elif tag == "rstart":
                _t, row, slot, sem = op
                assert scratch_ready[row]
                pending_refill[(row, slot, sem)] = scratch[row]
                pool_inflight.add(slot)
            elif tag == "rwait":
                _t, row, slot, sem = op
                pool[slot] = pending_refill.pop((row, slot, sem))
                pool_inflight.discard(slot)
            elif tag == "dstart":
                pending_dump = pool.copy()
            elif tag == "dwait":
                scratch[:prog.pool_slots] = pending_dump
                scratch_ready[:prog.pool_slots] = True
                pending_dump = None
            elif tag == "lstart":
                pending_load = scratch[:prog.pool_slots].copy()
            elif tag == "lwait":
                pool[:] = pending_load
                pending_load = None
            elif tag == "tput":
                _t, loc, sb, so = op
                assert sb not in pend_tf, \
                    "tput into a slab buffer with an in-flight flush"
                tslab[sb, so] = read(loc)
            elif tag == "tfstart":
                _t, sb, n, row0 = op
                assert sb not in pend_tf
                pend_tf[sb] = (n, row0, tslab[sb, :n].copy())
            elif tag == "tfwait":
                _t, sb, n, row0 = op
                pn, prow0, data = pend_tf.pop(sb)
                assert (pn, prow0) == (n, row0)
                tape[row0:row0 + n] = data
                tape_ok[row0:row0 + n] = True
            else:  # gate
                _t, kind, out_slot, locs, aux = op
                assert out_slot not in pool_inflight
                pool[out_slot] = _gate_scalar(read, kind, locs, aux)
        assert not pending_b and not pending_g and not pending_flush \
            and not pending_refill and pending_dump is None \
            and pending_load is None and not pend_tf
        top = float(pool[prog.top_slot])

    # ---- backward ----
    P = prog.pool_slots
    adj_scr = np.zeros(aprog.adj_rows)          # [0,P) dumps; [P,..) log
    adj_log_ready = np.ones(aprog.adj_rows, dtype=bool)
    adj = np.full(P, np.nan)
    tring = np.full((aprog.tape_bufs, aprog.tct), np.nan)
    pend_t: dict[int, tuple[int, np.ndarray]] = {}
    ibuf = np.full((aprog.inj_bufs, aprog.inj_chunk), np.nan)
    pend_i: dict[int, tuple[int, np.ndarray]] = {}
    aslab = np.full((prog.slab_bufs, prog.slab_tiles), np.nan)
    side = np.full(aprog.side_cap, np.nan)
    gcbuf = np.full((aprog.gcot_bufs, prog.brs_chunk), np.nan)
    icbuf = np.full((aprog.icot_bufs, prog.grs_chunk), np.nan)
    gcot = np.zeros(prog.brs_len_pad)
    pend_gc: dict[int, tuple[int, np.ndarray]] = {}
    pend_ic: dict[int, tuple[int, np.ndarray]] = {}
    pend_adump = pend_aload = None

    def vread(vloc):
        if vloc[0] == "tape":
            buf = vloc[1]
            assert buf not in pend_t, "read of in-flight tape buffer"
            v = tring[buf, vloc[2]]
            assert not np.isnan(v), "read of unloaded tape row"
            return float(v)
        return float(house[vloc[1]])

    def run_sub(ops):
        nonlocal pend_adump, pend_aload
        for op in ops:
            tag = op[0]
            if tag == "binit":
                adj[prog.top_slot] = ct
            elif tag == "lstart":
                pend_aload = adj_scr[:P].copy()
            elif tag == "lwait":
                adj[:] = pend_aload
                pend_aload = None
            elif tag == "dstart":
                pend_adump = adj.copy()
            elif tag == "dwait":
                adj_scr[:P] = pend_adump
                pend_adump = None
            elif tag == "tstart":
                _t, row0, n, buf = op
                assert buf not in pend_t
                # Chunks may span segment-alignment pad rows (never
                # written, never read) — vread's NaN check catches any
                # read of a genuinely unflushed row.
                pend_t[buf] = (row0, tape[row0:row0 + n].copy())
            elif tag == "twait":
                _t, row0, n, buf = op
                pr, data = pend_t.pop(buf)
                assert pr == row0
                tring[buf, :n] = data
            elif tag == "istart":
                _t, lo, n, buf = op
                assert buf not in pend_i
                pend_i[buf] = (lo, adj_scr[P + lo:P + lo + n].copy())
            elif tag == "iwait":
                _t, lo, n, buf = op
                pl, data = pend_i.pop(buf)
                assert pl == lo
                ibuf[buf, :n] = data
            elif tag == "gczero":
                assert op[1] not in pend_gc
                gcbuf[op[1], :] = 0.0
            elif tag == "gcstart":
                _t, c, buf = op
                assert buf not in pend_gc
                pend_gc[buf] = (c, gcbuf[buf].copy())
            elif tag == "gcwait":
                _t, c, buf = op
                pc, data = pend_gc.pop(buf)
                assert pc == c
                lo = c * prog.brs_chunk
                gcot[lo:lo + prog.brs_chunk] = data
            elif tag == "iczero":
                assert op[1] not in pend_ic
                icbuf[op[1], :] = 0.0
            elif tag == "icstart":
                _t, c, buf = op
                assert buf not in pend_ic
                pend_ic[buf] = (c, icbuf[buf].copy())
            elif tag == "icwait":
                _t, c, buf = op
                pc, data = pend_ic.pop(buf)
                assert pc == c
                lo = c * prog.grs_chunk
                icot[lo:lo + prog.grs_chunk] = data
            elif tag == "rside":
                _t, idx, slot = op
                v = adj[slot]
                assert not np.isnan(v), "rside of an unformed adjoint"
                side[idx] = v
            elif tag == "bevict":
                _t, slot, inj, slab_loc, sides = op
                v = 0.0
                if inj is not None:
                    buf, off = inj
                    assert buf not in pend_i, \
                        "bevict reads an in-flight injection buffer"
                    x = ibuf[buf, off]
                    assert not np.isnan(x), "bevict reads unloaded inj"
                    v += float(x)
                if slab_loc is not None:
                    x = aslab[slab_loc[0], slab_loc[1]]
                    assert not np.isnan(x), \
                        "bevict reads an unformed adjoint slab position"
                    v += float(x)
                for idx in sides:
                    x = side[idx]
                    assert not np.isnan(x), "bevict reads unset side"
                    v += float(x)
                adj[slot] = v
            else:  # bgate
                _t, kind, out_slot, bargs, aux = op
                a = adj[out_slot]
                assert not np.isnan(a), \
                    f"bgate reads unformed adjoint slot {out_slot}"
                xs = []
                for vloc, _g, neg in bargs:
                    v = vread(vloc)
                    xs.append(1.0 - v if neg else v)
                parts = _bgate_partials(kind, xs, aux)
                for (vloc, gloc, neg), dx in zip(bargs, parts):
                    if gloc is None:
                        continue
                    gval = (-dx if neg and kind != "mux" else dx) * a
                    if gloc[0] == "apool":
                        _ag, slot, firstq = gloc
                        if firstq:
                            adj[slot] = gval
                        else:
                            assert not np.isnan(adj[slot]), \
                                f"accumulate into unformed adj {slot}"
                            adj[slot] += gval
                    elif gloc[0] == "aslab":
                        _ag, sb, so, firstq = gloc
                        if firstq:
                            aslab[sb, so] = gval
                        else:
                            assert not np.isnan(aslab[sb, so])
                            aslab[sb, so] += gval
                    elif gloc[0] == "gcot":
                        _ag, c, off = gloc
                        buf = c % aprog.gcot_bufs
                        assert buf not in pend_gc, \
                            "gcot write during an in-flight flush"
                        assert not np.isnan(gcbuf[buf, off])
                        gcbuf[buf, off] = gval
                    else:  # icot
                        _ag, c, off = gloc
                        buf = c % aprog.icot_bufs
                        assert buf not in pend_ic
                        assert not np.isnan(icbuf[buf, off])
                        icbuf[buf, off] = gval
        assert not pend_t and not pend_i and not pend_gc and not pend_ic
        assert pend_adump is None and pend_aload is None

    for k in range(len(aprog.bwd_segments) - 1, -1, -1):
        icot = np.zeros(prog.grs_len_pad[k] or 1)
        for sub_ops in aprog.bwd_segments[k]:
            # Fresh kernel VMEM per sub-kernel: scratch contents do not
            # persist across pallas_calls — the split constraint says no
            # live state crosses a cut except the adjoint pool, which
            # rides the adjoint scratch dump/load.
            aslab[:] = np.nan
            side[:] = np.nan
            tring[:] = np.nan
            ibuf[:] = np.nan
            gcbuf[:] = np.nan
            icbuf[:] = np.nan
            adj[:] = np.nan
            run_sub(sub_ops)
        # XLA glue: scatter-add this segment's gate-stream cotangents
        # into the adjoint log.
        n_raw = prog.grs_len[k]
        if n_raw:
            rows = prog.grs_rows[k][:n_raw]   # rows are already P + e
            np.add.at(adj_scr, rows, icot[:n_raw])

    # Final XLA glue: scatter-add the gradient stream by basic column.
    grad = np.zeros(prog.n_basic)
    np.add.at(grad, prog.brs_cols, gcot)
    return top, grad
