"""Block-gather propagation: CUDA level kernels (log, direct), plain version.

The counterpart of ``canopy_tpu/ops/block_gather.py``, the engine for big
product trees whose slots the locality pass (``compiler/reorder.py``,
``locality_reorder(hot_first=True)``) has reordered.  Per level the
gates run in 128-gate chunks; each chunk reads a *window* of rows: its
local range (``r_rows`` rows from ``chunk_starts``), the level's resident
128-row slabs (shared events), and 8 neutral rows of value 1.  Every
argument is a selection into that window:

    log:     y   = sum_f L[sel_idx[g, f]],  L = [log v ; log(1 - v)]
             out = inv + (1 - 2 inv) * exp(y)
    direct:  out = inv + (1 - 2 inv) * prod_f (flip + (1 - 2 flip) x[sel_raw])

The host half -- ``_LevelPlan``, :class:`BlockGatherProgram`,
:func:`block_gather_supported` and :func:`compile_block_gather` with its
``w_resident=4``, ``r_max=4096`` and ``LogicError`` refusals -- is the
JAX package's, unchanged.  The TPU kernels select through one-hot
matrix products on the matrix unit; on Hopper the selection is an index
into the window, read from device memory (``csrc/block_gather.cu``, one
launch per level, a block per (chunk, trial tile)), and the sum runs in
``f`` order in float32 on the CUDA cores: a TF32 product would break the
1e-5 contract.  So the log mode agrees with
the JAX package to a tolerance (its sum runs in matmul order), and the
direct mode bit for bit (a one-hot float32 product copies a value
exactly).

:func:`auto_t_tile` is re-derived for the card: the trial tile is a
block's width, 128 trials whatever the windows (no window takes shared
memory, so none caps it).

Logs are clamped as ``max(log(max(v, 0)), -1e4)``: the JAX package's
``max(v, 1e-300)`` floor is 0 in float32, so ``log(0) = -inf`` clamps to
-1e4 and ``exp(-1e4) = 0`` exactly, which keeps hard 0/1 inputs exact.

Dispatch.  :func:`block_gather_propagate` runs
:func:`block_gather_forward_plain` for a CPU tensor and the kernels for a
CUDA tensor, or raises; ``COUNTERS["launch.block_log"]`` and
``COUNTERS["launch.block_direct"]`` count launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.graph import CompiledTree, merge_prod_level
from ..errors import LogicError
from ..utils.profiling import COUNTERS
from ._build import _raise_on, load_library

__all__ = ["compile_block_gather", "block_gather_propagate",
           "block_gather_supported", "BlockGatherProgram", "auto_t_tile",
           "stage_block_gather", "block_gather_levels",
           "block_gather_forward_plain"]

_CHUNK = 128        # Gates per grid step (one MXU row block).
_SLAB = 128         # Resident slab height (rows).
_NEUTRAL = 8        # Neutral rows appended to the resident buffer (v=1).
_LOG_CLAMP = -1e4   # exp(-1e4) underflows to exactly 0 in f32.


@dataclasses.dataclass
class _LevelPlan:
    out_start: int            # First output row of the level.
    n_gates: int
    n_chunks: int
    fan: int
    r_rows: int               # Local-range rows DMA'd per chunk.
    resident_rows: np.ndarray  # (W,) slab start rows (W may be 0).
    chunk_starts: np.ndarray  # (n_chunks, 1) int32, 8-row aligned.
    sel_idx: np.ndarray       # (n_chunks*128, fan) int32 into [0, 2C).
    inv_out: np.ndarray       # (n_chunks*128, 1) f32 (1.0 = complement).
    #: Direct-space mode: indices into [0, C) + separate flip masks
    #: (selection matmuls copy raw values; complements on the VPU).
    sel_raw: np.ndarray | None = None    # (n_chunks*128, fan) int32
    flip: np.ndarray | None = None       # (n_chunks*128, fan) f32

    @property
    def c_rows(self) -> int:
        return self.r_rows + len(self.resident_rows) * _SLAB + _NEUTRAL


@dataclasses.dataclass
class BlockGatherProgram:
    n_basic: int
    n_rows: int               # Padded value-matrix rows (8-aligned + margin).
    top_index: int
    levels: list[_LevelPlan]
    nnz: int

    def hbm_rows_per_level(self) -> list[int]:
        """Rows DMA'd per level (the traffic model, for roofline checks)."""
        return [lv.n_chunks * lv.r_rows
                + len(lv.resident_rows) * _SLAB + lv.n_chunks * _CHUNK
                for lv in self.levels]


def block_gather_supported(tree: CompiledTree) -> bool:
    return tree.n_house == 0 and tree.top_index is not None and all(
        not level.pairs and not level.counts for level in tree.levels)


#: A block's trial width (the default ``t_tile``).
_T_TILE = 128
#: Trials per slab of the plain version (bounds its temporaries on the
#: card at 65,536 trials).
_PLAIN_TRIALS = 8192
_MODES = ("log", "direct")


def auto_t_tile(program: "BlockGatherProgram", cap: int = 512) -> int:
    """A block's trial width on the card: 128 trials for every program
    (the kernels read their windows from device memory, so no level's
    window caps it).  ``cap`` below 128 raises ``LogicError``, as the JAX
    package's does."""
    if cap < _T_TILE:
        raise LogicError(f"block-gather: t_tile cap {cap} is under "
                         f"{_T_TILE} trials")
    return _T_TILE


def compile_block_gather(tree: CompiledTree, w_resident: int = 4,
                         r_max: int = 4096) -> BlockGatherProgram:
    """Host-side schedule: per level, resident slabs + chunk ranges +
    in-VMEM selection indices."""
    if not block_gather_supported(tree):
        raise LogicError("block-gather needs prod-family-only levels, "
                         "no house events, and a top index")
    n_rows = -(-tree.n_nodes // 8) * 8 + _CHUNK  # Write margin.
    plans: list[_LevelPlan] = []
    for level in tree.levels:
        merged = merge_prod_level(level)
        G, F = merged.arg_idx.shape
        n_chunks = -(-G // _CHUNK)
        gp = n_chunks * _CHUNK

        args = merged.arg_idx.astype(np.int64)
        mask = merged.arg_mask

        # Resident slabs by GREEDY SPAN RELIEF: the local-range DMA
        # covers each chunk's dense core for free, so residency should
        # go to whatever slab currently inflates the worst chunk's
        # span (shared events / cross-subsystem couplings).  Repeat:
        # find the chunk with the widest non-resident span, evict the
        # extreme slab (min or max side, whichever shrinks it more)
        # into the resident set.  Plain reference counts or fixed
        # outlier thresholds both misallocate slots (measured).
        slab_of = args // _SLAB
        arg_rows_p = np.full((n_chunks * _CHUNK, F), -1, dtype=np.int64)
        arg_rows_p[:G] = np.where(mask, args, -1)
        by_chunk = [np.sort(r[r >= 0]) for r in
                    arg_rows_p.reshape(n_chunks, _CHUNK * F)]
        resident_set: set[int] = set()

        def chunk_span(rows):
            if not len(rows):
                return 0, rows
            keep = ~np.isin(rows // _SLAB, list(resident_set)) \
                if resident_set else np.ones(len(rows), bool)
            rows = rows[keep]
            if not len(rows):
                return 0, rows
            return int(rows[-1] - rows[0] + 1), rows

        while len(resident_set) < w_resident:
            spans = [chunk_span(r) for r in by_chunk]
            worst = max(range(n_chunks), key=lambda c: spans[c][0])
            span, rows = spans[worst]
            if span <= _SLAB * 2:
                break
            # Evict the *side* of the largest slab gap (fewer slabs
            # wins): a chunk reading {shared window} + {dense core} has
            # its span set by the far side as a whole — single-slab
            # eviction is myopic (removing one of two shared slabs
            # changes nothing, so it never looks profitable).
            slabs = np.unique(rows // _SLAB)
            if len(slabs) < 2:
                break
            gap_at = int(np.argmax(np.diff(slabs)))
            lo_side = slabs[:gap_at + 1]
            hi_side = slabs[gap_at + 1:]
            side = lo_side if len(lo_side) <= len(hi_side) else hi_side
            budget = w_resident - len(resident_set)
            if len(side) > budget:
                break  # Cannot clear the side; more evictions won't help.
            resident_set.update(int(s) for s in side)
        resident = np.sort(np.array(sorted(resident_set), dtype=np.int64))
        res_pos = {int(s): i for i, s in enumerate(resident)}
        is_res = np.isin(slab_of, resident) & mask

        # Per-chunk local ranges over non-resident args.
        local = mask & ~is_res
        chunk_starts = np.zeros((n_chunks, 1), dtype=np.int32)
        r_rows = 8
        arg_pad = np.full((gp, F), -1, dtype=np.int64)
        arg_pad[:G] = np.where(local, args, -1)
        arg_chunks = arg_pad.reshape(n_chunks, _CHUNK * F)
        for c in range(n_chunks):
            rows = arg_chunks[c][arg_chunks[c] >= 0]
            if len(rows):
                start = (int(rows.min()) // 8) * 8
                span = int(rows.max()) - start + 1
                chunk_starts[c, 0] = start
                r_rows = max(r_rows, -(-span // 8) * 8)
        if r_rows > r_max:
            raise LogicError(
                f"block-gather: level chunk span {r_rows} exceeds "
                f"r_max={r_max} (reorder the tree or fall back)")
        # The DMA window is r_rows high for every chunk; clamp starts so
        # windows stay inside the padded matrix (lowering a start only
        # widens coverage downward, never uncovers an argument).
        chunk_starts = np.minimum(chunk_starts, n_rows - r_rows) \
            .astype(np.int32)

        w = len(resident)
        c_rows = r_rows + w * _SLAB + _NEUTRAL
        neutral = r_rows + w * _SLAB  # First neutral row (value 1.0).

        sel = np.full((gp, F), neutral, dtype=np.int32)
        for c in range(n_chunks):
            lo = c * _CHUNK
            hi = min(lo + _CHUNK, G)
            a = args[lo:hi]
            m = mask[lo:hi]
            res = is_res[lo:hi]
            base = np.full(a.shape, neutral, dtype=np.int64)
            # Local args -> offset within the chunk's range.
            base = np.where(m & ~res, a - chunk_starts[c, 0], base)
            # Resident args -> R + slab_pos*128 + row-in-slab.
            if w:
                pos = np.vectorize(lambda s: res_pos.get(int(s), 0))(
                    a // _SLAB)
                base = np.where(res, r_rows + pos * _SLAB + a % _SLAB,
                                base)
            # Complement edges read the log(1-v) half.
            flip = merged.arg_flip[lo:hi] & m
            sel[lo:hi] = (base + np.where(flip, c_rows, 0)).astype(np.int32)

        inv = np.zeros((gp, 1), dtype=np.float32)
        inv[:G, 0] = merged.inv_out.astype(np.float32)
        # Direct-space companion arrays: raw index (no doubling) +
        # flip mask; padded lanes select the neutral row with flip 0.
        sel_raw = np.where(sel >= c_rows, sel - c_rows, sel) \
            .astype(np.int32)
        flip_arr = (sel >= c_rows).astype(np.float32)
        plans.append(_LevelPlan(
            out_start=int(merged.out_idx[0]), n_gates=G,
            n_chunks=n_chunks, fan=F, r_rows=r_rows,
            resident_rows=(resident * _SLAB).astype(np.int32),
            chunk_starts=chunk_starts, sel_idx=sel, inv_out=inv,
            sel_raw=sel_raw, flip=flip_arr))
    return BlockGatherProgram(n_basic=tree.n_basic, n_rows=n_rows,
                              top_index=tree.top_index, levels=plans,
                              nnz=tree.nnz)


def _clamped_log(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.log(torch.clamp(v, min=0.0)), min=_LOG_CLAMP)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise LogicError(f"block-gather: unknown mode {mode!r} "
                         "(expected 'log' or 'direct')")


def _resolved(plan: _LevelPlan, n_rows: int) -> tuple[np.ndarray, ...]:
    """Each selection as a value-matrix row (the neutral rows -> row
    ``n_rows``, a row of ones) and whether it reads ``log(1 - v)``:
    ``(rows (G, fan) int64, comp (G, fan) bool)`` for the level's ``G``
    gates (cached on the plan)."""
    cached = plan.__dict__.get("_resolved")
    if cached is not None:
        return cached
    G = plan.n_gates
    raw = plan.sel_raw[:G].astype(np.int64)
    chunk = np.arange(G) // _CHUNK
    start = plan.chunk_starts[chunk, 0].astype(np.int64)[:, None]
    res_lo = plan.r_rows + len(plan.resident_rows) * _SLAB
    rows = np.full(raw.shape, n_rows, dtype=np.int64)
    local = raw < plan.r_rows
    rows[local] = (start + raw)[local]
    res = (raw >= plan.r_rows) & (raw < res_lo)
    if res.any():
        k = raw[res] - plan.r_rows
        rows[res] = plan.resident_rows[k // _SLAB].astype(np.int64) \
            + k % _SLAB
    comp = plan.sel_idx[:G] >= plan.c_rows
    plan._resolved = (rows, comp)
    return plan._resolved


def _level_plain(vals: torch.Tensor, plan: _LevelPlan, n_rows: int,
                 mode: str) -> torch.Tensor:
    """One level's ``(G, t)`` outputs from a staged ``vals`` (last row
    ones), the kernels' arithmetic in the same order."""
    rows, comp = _resolved(plan, n_rows)
    dev = vals.device
    G = plan.n_gates
    inv = torch.from_numpy(plan.inv_out[:G]).to(dev)           # (G, 1)
    acc = None
    for f in range(plan.fan):
        v = vals[torch.from_numpy(rows[:, f]).to(dev)]
        if mode == "log":
            c = torch.from_numpy(comp[:, f]).to(dev)[:, None]
            x = torch.where(c, _clamped_log(1.0 - v), _clamped_log(v))
            acc = x if acc is None else acc + x
        else:
            fl = torch.from_numpy(plan.flip[:G, f:f + 1]).to(dev)
            x = fl + (1.0 - 2.0 * fl) * v
            acc = x if acc is None else acc * x
    if mode == "log":
        acc = torch.exp(acc)
    return inv + (1.0 - 2.0 * inv) * acc


def _levels_plain(program: BlockGatherProgram, vals: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Every level of a staged ``vals`` in place, in plain torch; the top
    row ``(T,)``."""
    for plan in program.levels:
        vals[plan.out_start:plan.out_start + plan.n_gates] = \
            _level_plain(vals, plan, program.n_rows, mode)
    return vals[program.top_index].clone()


def stage_block_gather(program: BlockGatherProgram,
                       basic_p: torch.Tensor) -> torch.Tensor:
    """``(T, n_basic)`` -> the value matrix ``(n_rows + 1, T)`` float32 on
    ``basic_p``'s device: basic rows, zero gate rows, and a last row of
    ones (the plain version's neutral row; the kernels never read it)."""
    T = basic_p.shape[0]
    vals = torch.empty((program.n_rows + 1, T), dtype=torch.float32,
                       device=basic_p.device)
    vals[:program.n_basic].copy_(basic_p.T)
    vals[program.n_basic:program.n_rows].zero_()
    vals[program.n_rows] = 1.0
    return vals


def _level_tensors(program: BlockGatherProgram, device) -> list[tuple]:
    """Per level ``(starts, resident, sel_idx, sel_raw, flip, inv)`` on
    ``device`` (cached on the program per device)."""
    cache = program.__dict__.setdefault("_device_tables", {})
    key = str(device)
    if key not in cache:
        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
        cache[key] = [
            (t(plan.chunk_starts.reshape(-1), np.int32),
             t(plan.resident_rows if len(plan.resident_rows) else [0],
               np.int32),
             t(plan.sel_idx, np.int32), t(plan.sel_raw, np.int32),
             t(plan.flip, np.float32), t(plan.inv_out.reshape(-1), np.float32))
            for plan in program.levels]
    return cache[key]


def block_gather_levels(program: BlockGatherProgram, vals: torch.Tensor,
                        width: int, mode: str = "log") -> torch.Tensor:
    """Every level in place on a staged value matrix; returns the top
    row ``(T,)``.  A CPU matrix runs the plain version level by level; a
    CUDA one launches ``csrc/block_gather.cu`` once per level with blocks
    of ``width`` trials (``T % width == 0``), or raises."""
    _check_mode(mode)
    T = vals.shape[1]
    if vals.shape[0] != program.n_rows + 1 or vals.dtype != torch.float32 \
            or not vals.is_contiguous() or width <= 0 or T % width:
        raise LogicError(f"block-gather levels take a staged "
                         f"({program.n_rows + 1}, T) float32 matrix and a "
                         f"width dividing T, got {tuple(vals.shape)} "
                         f"{vals.dtype}, {width}")
    if vals.device.type != "cuda":
        return _levels_plain(program, vals, mode)
    lib = load_library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    log_mode = mode == "log"
    key = "block_log" if log_mode else "block_direct"
    for plan, (starts, resident, sel_idx, sel_raw, flip, inv) in zip(
            program.levels, _level_tensors(program, vals.device)):
        COUNTERS["launch." + key] += 1
        code = lib.canopy_block_gather_level(
            vals.data_ptr(), T, starts.data_ptr(), resident.data_ptr(),
            (sel_idx if log_mode else sel_raw).data_ptr(), flip.data_ptr(),
            inv.data_ptr(), plan.n_chunks, plan.r_rows,
            len(plan.resident_rows), plan.fan, plan.c_rows, plan.out_start,
            plan.n_gates, width, int(log_mode), stream)
        _raise_on(lib, code, f"block-gather {mode} level")
    return vals[program.top_index].clone()


def block_gather_forward_plain(program: BlockGatherProgram,
                               basic_p: torch.Tensor,
                               mode: str = "log") -> torch.Tensor:
    """``(T, n_basic)`` -> ``(T,)`` float32 tops: the kernels' arithmetic
    in plain torch on ``basic_p``'s device, in slabs of
    ``_PLAIN_TRIALS`` trials (so it fits the card at 65,536 trials)."""
    _check_mode(mode)
    return torch.cat([
        _levels_plain(program, stage_block_gather(program, slab), mode)
        for slab in basic_p.split(_PLAIN_TRIALS)])


def block_gather_propagate(program: BlockGatherProgram,
                           basic_p: torch.Tensor, t_tile: int | None = None,
                           mode: str = "log") -> torch.Tensor:
    """(T, n_basic) -> (T,) float32 top probabilities on ``basic_p``'s
    device.

    ``T`` must be a multiple of 128 and, when larger than ``t_tile``, of
    ``t_tile`` (the JAX package's refusals).  On the card ``t_tile``
    (default :func:`auto_t_tile`) is a block's trial width, and each level
    is one launch over all trials; on the CPU the plain version runs.
    ``mode``: ``"log"`` (the log-space sum, ~1e-6 relative) or
    ``"direct"`` (the product, bit-equal to the float32 gather engine).
    """
    _check_mode(mode)
    T = basic_p.shape[0]
    if T % 128:
        raise LogicError("block-gather needs T % 128 == 0")
    if t_tile is None:
        t_tile = auto_t_tile(program)
    if T > t_tile and T % t_tile:
        raise LogicError("T must divide into t_tile slabs")
    if basic_p.ndim != 2 or basic_p.shape[1] != program.n_basic:
        raise LogicError(f"block-gather takes (T, {program.n_basic}) "
                         f"probabilities, got {tuple(basic_p.shape)}")
    if basic_p.device.type != "cuda":
        return block_gather_forward_plain(program, basic_p, mode)
    return block_gather_levels(program, stage_block_gather(program, basic_p),
                               min(t_tile, T), mode)
