"""BSR log-space propagation on PyTorch: a block-sparse product per level.

The counterpart of ``canopy_tpu/ops/bsr_propagate.py``.  Each level of a
product-family tree is one block-sparse matrix product in log space:

    x_edge  = flip ? (1 - v_src) : v_src          (edge literal)
    y_gate  = sum_edges log(x_edge)               (product in log space)
    value   = inv_out ? 1 - exp(y) : exp(y)

The log-sum is ``S @ L`` where ``S`` is the 0/1 level structure matrix
over a **doubled column space** -- column ``c`` reads ``log(v_c)``,
column ``N + c`` reads ``log(1 - v_c)`` -- so per-edge flips cost nothing.
``S`` is stored as BSR: ``row_block``-gate row blocks x 128-column
blocks, each a dense float32 tile.  The host half (:func:`compile_bsr`,
:func:`estimate_bsr_fill`, :func:`bsr_cost_report`) is the JAX package's,
unchanged; the reorder pass (``compiler/reorder.py``, ``method="auto"``)
ranks orderings by :func:`estimate_bsr_fill`.

The JAX package computes the product outside any Pallas kernel (an XLA
einsum), and so does the port: :func:`bsr_top_probability` is torch
operations -- the block gather, ``torch.einsum("prc,pct->prt")``,
``index_add_`` for the segment sum, the same incremental log-matrix
update, and trial slabs of ``t_chunk`` as a Python loop.

Numerics: logs are clamped at -1e4 (exp underflows to exactly 0 in f32),
so hard 0/1 inputs stay exact; otherwise f32 log/exp round-trip error is
~1e-6 relative -- the same class as the f32 product engine.  The product
must run in full float32: a TF32 matrix product keeps 10 mantissa bits
(about 1e-3 relative in the logs), so this module sets no matmul
precision, relies on PyTorch's default (``allow_tf32`` off), and raises
``LogicError`` on a CUDA tensor when a caller has turned TF32 on
(``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision("high")``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..errors import LogicError

__all__ = ["compile_bsr", "bsr_arrays", "bsr_top_probability",
           "bsr_cost_report", "estimate_bsr_fill"]

_BLOCK = 128        # Column block (MXU contraction dim).
# Default row block.  Wider row blocks amortize each gathered 128-column
# slab over more gates (HBM floats/nnz at 8/32 on the reordered
# branching-8 hierarchical bench: 9.5/5.0) but store proportionally
# larger mostly-zero tiles (fill 76x/161x).  Measured on v5e: 6.30 vs
# 7.98 G/s — the engine is overhead-bound at PRA level sizes, not
# bandwidth-bound, so the narrow block keeps 2x memory for a ~21 % perf
# cost; 128-row tiles are impractical (tile arrays reach hundreds of MB).
_ROW_BLOCK = 8
_LOG_CLAMP = -1e4


@dataclasses.dataclass
class _BsrLevel:
    out_start: int            # First gate slot of the level (contiguous).
    n_gates: int
    n_row_blocks: int
    row_block: int
    # Flattened (row_block, col_block) pairs:
    pair_rows: np.ndarray     # (P,) row-block index within the level
    pair_cols: np.ndarray     # (P,) col-block index into the doubled space
    blocks: np.ndarray        # (P, ROW_BLOCK, 128) f32 structure tiles
    inv_out: np.ndarray       # (n_gates,) bool


@dataclasses.dataclass
class BsrProgram:
    n_nodes: int
    n_pad: int                # Node count padded to a block multiple.
    n_basic: int
    n_house: int
    top_index: int
    levels: list[_BsrLevel]
    nnz: int
    fill_blocks: int          # Total (row_block x 128) tiles stored.
    row_block: int = _ROW_BLOCK

    @property
    def fill_ratio(self) -> float:
        """Stored tile entries per structural nonzero (the MXU waste)."""
        return self.fill_blocks * self.row_block * _BLOCK / max(self.nnz, 1)

    @property
    def hbm_floats_per_nnz(self) -> float:
        """Gathered column-slab floats per nnz — the actual bandwidth
        cost model (tile count x 128, NOT tile entries)."""
        return self.fill_blocks * _BLOCK / max(self.nnz, 1)


def compile_bsr(tree: CompiledTree,
                row_block: int = _ROW_BLOCK) -> BsrProgram:
    """Build the per-level BSR structure from a compiled tree.

    Requires prod-family-only levels (the benchmark/production fast path;
    pair/count gates fall back to the gather engine).
    """
    levels: list[_BsrLevel] = []
    fill_blocks = 0
    n_pad = -(-tree.n_nodes // _BLOCK) * _BLOCK
    for level in tree.levels:
        if level.pairs or level.counts:
            raise LogicError(
                "BSR propagation supports product-family levels only.")
        if not level.prods:
            continue
        # Merge the level's buckets into one row-ordered edge list
        # (vectorized: benchmark-scale levels have millions of edges).
        out_start = min(int(b.out_idx[0]) for b in level.prods)
        n_gates = sum(b.n_gates for b in level.prods)
        inv_out = np.zeros(n_gates, dtype=bool)
        n_row_blocks = -(-n_gates // row_block)
        rows_list, cols_list = [], []
        for block in level.prods:
            rows_b = np.repeat(block.out_idx.astype(np.int64) - out_start,
                               block.arg_idx.shape[1])
            cols_b = block.arg_idx.astype(np.int64).reshape(-1)
            cols_b = cols_b + np.where(block.arg_flip.reshape(-1), n_pad, 0)
            keep = block.arg_mask.reshape(-1)
            rows_list.append(rows_b[keep])
            cols_list.append(cols_b[keep])
            inv_out[block.out_idx - out_start] = block.inv_out
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        rb, r_in = np.divmod(rows, row_block)
        cb, c_in = np.divmod(cols, _BLOCK)
        pair_key = rb * (2 * n_pad // _BLOCK) + cb
        unique_keys, pair_of_edge = np.unique(pair_key,
                                              return_inverse=True)
        tiles = np.zeros((len(unique_keys), row_block, _BLOCK),
                         dtype=np.float32)
        np.add.at(tiles, (pair_of_edge, r_in, c_in), 1.0)
        levels.append(_BsrLevel(
            out_start=out_start, n_gates=n_gates,
            n_row_blocks=n_row_blocks,
            pair_rows=(unique_keys // (2 * n_pad // _BLOCK))
            .astype(np.int32),
            pair_cols=(unique_keys % (2 * n_pad // _BLOCK))
            .astype(np.int32),
            blocks=tiles, inv_out=inv_out, row_block=row_block))
        fill_blocks += len(unique_keys)
    return BsrProgram(n_nodes=tree.n_nodes, n_pad=n_pad,
                      n_basic=tree.n_basic,
                      n_house=tree.n_house, top_index=tree.top_index,
                      levels=levels, nnz=tree.nnz, fill_blocks=fill_blocks,
                      row_block=row_block)


def bsr_arrays(program: BsrProgram, device) -> list[tuple]:
    """The program's tensors on ``device``, one ``(blocks, pair_cols,
    pair_rows, inv_out)`` tuple per level; hot loops build them once and
    pass them as ``params``."""
    device = torch.device(device)
    return [(torch.from_numpy(level.blocks).to(device),
             torch.from_numpy(level.pair_cols.astype(np.int64)).to(device),
             torch.from_numpy(level.pair_rows.astype(np.int64)).to(device),
             torch.from_numpy(level.inv_out).to(device))
            for level in program.levels]


def _logs_of(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[log v, log(1 - v)]`` clamped at ``_LOG_CLAMP``.  The JAX
    package's ``max(v, 1e-300)`` floor is 0 in float32, so ``log(0) =
    -inf`` clamps to -1e4 and ``exp(-1e4)`` is exactly 0."""
    lv = torch.clamp(torch.log(torch.clamp(v, min=0.0)), min=_LOG_CLAMP)
    l1 = torch.clamp(torch.log(torch.clamp(1.0 - v, min=0.0)),
                     min=_LOG_CLAMP)
    return lv, l1


def bsr_top_probability(program: BsrProgram, basic_p: torch.Tensor,
                        house_states=None, t_chunk: int = 256,
                        params: list[tuple] | None = None) -> torch.Tensor:
    """(T, n_basic) -> (T,) float32 top probabilities through the BSR
    engine, on ``basic_p``'s device.

    The trials axis is processed in ``t_chunk`` slabs (when ``T`` is a
    multiple of it) to bound the gathered-block workspace at ``tiles x
    128 x t_chunk`` floats.  On a CUDA tensor with TF32 matrix products
    turned on it raises ``LogicError`` (TF32 breaks the ~1e-6 contract).
    """
    device = basic_p.device
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise LogicError("BSR propagation needs full float32 matrix "
                         "products; TF32 is on (allow_tf32 or float32 "
                         "matmul precision below 'highest')")
    if params is None:
        params = bsr_arrays(program, device)
    T = basic_p.shape[0]
    if T > t_chunk and T % t_chunk == 0:
        return torch.cat([
            bsr_top_probability(program, chunk, house_states,
                                t_chunk=t_chunk, params=params)
            for chunk in basic_p.split(t_chunk)])
    dtype = torch.float32
    parts = [basic_p.T.to(dtype)]                          # (n_basic, T)
    if program.n_house:
        house = torch.as_tensor(np.asarray(house_states), dtype=dtype,
                                device=device)
        parts.append(house[:, None].expand(program.n_house, T))
    # The state is the doubled log matrix L = [log v | log(1-v)], updated
    # *incrementally*: only each level's newly produced rows get their
    # logs recomputed.
    n_pad = program.n_pad
    parts.append(torch.zeros((n_pad - program.n_basic - program.n_house, T),
                             dtype=dtype, device=device))
    L = torch.cat(_logs_of(torch.cat(parts)), dim=0)       # (2*n_pad, T)
    top_value = None

    for level, (blocks, pair_cols, pair_rows, inv_out) in zip(
            program.levels, params):
        gathered = L.view(-1, _BLOCK, T)[pair_cols]         # (P, 128, T)
        partial = torch.einsum("prc,pct->prt", blocks, gathered)
        y = torch.zeros((level.n_row_blocks, level.row_block, T),
                        dtype=dtype, device=device)
        y.index_add_(0, pair_rows, partial)
        y = y.reshape(level.n_row_blocks * level.row_block,
                      T)[:level.n_gates]
        prod = torch.exp(y)
        out = torch.where(inv_out[:, None], 1.0 - prod, prod)
        lo = level.out_start
        if lo <= program.top_index < lo + level.n_gates:
            top_value = out[program.top_index - lo]
        new_lv, new_l1 = _logs_of(out)
        L[lo:lo + level.n_gates] = new_lv
        L[n_pad + lo:n_pad + lo + level.n_gates] = new_l1
    if top_value is None:
        raise LogicError("top gate not covered by any level")
    return top_value


def estimate_bsr_fill(tree: CompiledTree,
                      row_block: int = _ROW_BLOCK) -> float:
    """The fill ratio :func:`compile_bsr` would produce, without
    materializing any tile (used for ordering selection: the reorder
    pass evaluates candidate permutations by this number)."""
    n_pad = -(-tree.n_nodes // _BLOCK) * _BLOCK
    tiles = 0
    nnz = 0
    for level in tree.levels:
        if not level.prods:
            continue
        out_start = min(int(b.out_idx[0]) for b in level.prods)
        keys = []
        for block in level.prods:
            rows_b = np.repeat(block.out_idx.astype(np.int64) - out_start,
                               block.arg_idx.shape[1])
            cols_b = block.arg_idx.astype(np.int64).reshape(-1)
            cols_b = cols_b + np.where(block.arg_flip.reshape(-1), n_pad, 0)
            keep = block.arg_mask.reshape(-1)
            keys.append((rows_b[keep] // row_block)
                        * (2 * n_pad // _BLOCK)
                        + cols_b[keep] // _BLOCK)
            nnz += int(keep.sum())
        tiles += len(np.unique(np.concatenate(keys)))
    return tiles * row_block * _BLOCK / max(nnz, 1)


def bsr_cost_report(program: BsrProgram) -> dict:
    return {"nnz": program.nnz,
            "tiles": program.fill_blocks,
            "fill_ratio": program.fill_ratio,
            "levels": len(program.levels)}
