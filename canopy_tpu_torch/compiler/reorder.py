"""Locality-manufacturing slot reordering (the graph-partitioning pass).

The BSR/MXU engine (``ops/bsr_propagate``) pays for every 128-column
block a gate row-block touches; its viability is a pure function of
*argument locality* — how tightly each row block's argument columns
cluster.  Real plant models have that locality structurally (components
feed their own subsystem's gates) but lose it to incidental slot
assignment (the compiler's default deterministic-by-id ordering, the
reference's alphabetical tables — ``element.h:388-393``'s hashed ids
have no locality at all).  This pass *recovers* it:

* A **first-use pass** (vectorized DFS order): levels are processed
  top-down; each level's gates sort by the lexicographic key
  *(slot of their first consumer, argument position within it)* — for a
  tree this reproduces depth-first subtree order exactly, making every
  subsystem's gates and events contiguous again no matter how scrambled
  the input slot assignment was.  Basic events sort by the same key.
* **Barycenter sweeps** as refinement (the Sugiyama layered-drawing
  heuristic, the standard cheap proxy for bandwidth-minimizing
  orderings like Cuthill-McKee, adapted to the level schedule):
  alternate

  - a **downward pass** — order basic events and each level's gates by
    the mean position of their *consumers*, and
  - an **upward pass** — order each level's gates by the mean position
    of their *arguments* (processed bottom-up so argument positions are
    already final).

* The permutation respects every engine invariant: levels keep their
  slot ranges, every family/fan-in block keeps its contiguous output
  range (rows only move *within* their block), house events stay put,
  and per-row argument order is untouched — so propagation results are
  **bit-identical** (same multiplies in the same order), only the slot
  numbering changes.

O(nnz) per sweep, pure numpy, runs once at compile time.

Reference anchor: SURVEY.md §7 step 7 names "balanced partitioning"
as the designated hard part of scale-out; this pass is the single-chip
half (intra-matrix locality), and its permutation is also the natural
input ordering for the row partitioner (``parallel/partition.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CompiledTree, CountBlock, LevelBlock, PairBlock, ProdBlock

__all__ = ["locality_reorder", "apply_permutation", "random_shuffle",
           "ReorderedTree"]


@dataclasses.dataclass
class ReorderedTree:
    """A reordered tree plus the slot permutation that produced it.

    ``perm[old_slot] = new_slot`` over the full value vector.  A
    probability vector for the original tree maps to the new tree with
    :meth:`permute_basic`.
    """

    tree: CompiledTree
    perm: np.ndarray

    def permute_basic(self, basic_p: np.ndarray) -> np.ndarray:
        """Map a (..., n_basic) vector from old to new slot order."""
        n_basic = self.tree.n_basic
        inv = np.empty(n_basic, dtype=np.int64)
        inv[self.perm[:n_basic]] = np.arange(n_basic)
        return np.asarray(basic_p)[..., inv]


def _iter_blocks(tree: CompiledTree):
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            if block.n_gates:
                yield kind, block


def _masked_edges(block) -> tuple[np.ndarray, np.ndarray]:
    """(row_of_edge, col_of_edge) for a block's real (unmasked) edges."""
    if isinstance(block, PairBlock):
        G = block.n_gates
        rows = np.repeat(np.arange(G), 2)
        cols = block.arg_idx.reshape(-1).astype(np.int64)
        return rows, cols
    mask = block.arg_mask
    G, F = block.arg_idx.shape
    rows = np.repeat(np.arange(G), F)[mask.reshape(-1)]
    cols = block.arg_idx.reshape(-1).astype(np.int64)[mask.reshape(-1)]
    return rows, cols


def apply_permutation(tree: CompiledTree, perm: np.ndarray) -> CompiledTree:
    """Rebuild ``tree`` with value slots renumbered by ``perm``.

    ``perm`` must keep each block's output-slot *set* intact (rows may
    swap within a block only) and fix house-event slots; this is exactly
    what :func:`locality_reorder` and :func:`random_shuffle` produce.
    """
    perm = np.asarray(perm, dtype=np.int64)
    new_levels: list[LevelBlock] = []
    for level in tree.levels:
        prods, pairs, counts = [], [], []
        for kind, block in level.iter_blocks():
            if not block.n_gates:
                continue
            new_out = perm[block.out_idx.astype(np.int64)]
            order = np.argsort(new_out, kind="stable")
            out_idx = new_out[order].astype(np.int32)
            if not np.array_equal(
                    out_idx,
                    np.arange(out_idx[0], out_idx[0] + len(out_idx),
                              dtype=np.int32)):
                raise ValueError(
                    "permutation breaks a block's contiguous output range")
            arg_idx = perm[block.arg_idx.astype(np.int64)][order] \
                .astype(np.int32)
            if kind == "prod":
                prods.append(ProdBlock(
                    out_idx, arg_idx, block.arg_flip[order],
                    block.arg_mask[order], block.inv_out[order]))
            elif kind == "pair":
                pairs.append(PairBlock(
                    out_idx, arg_idx, block.arg_neg[order],
                    block.is_iff[order]))
            else:
                counts.append(CountBlock(
                    out_idx, arg_idx, block.arg_neg[order],
                    block.arg_mask[order], block.min_num[order],
                    block.max_num[order], block.cap))
        new_levels.append(LevelBlock(prods=prods, pairs=pairs,
                                     counts=counts))

    def _remap_index(index: dict[str, int]) -> dict[str, int]:
        return {name: int(perm[slot]) for name, slot in index.items()}

    def _permute_list(items: list, base: int) -> list:
        if not items:
            return items
        slots = perm[base:base + len(items)] - base
        out = [None] * len(items)
        for i, s in enumerate(slots):
            out[int(s)] = items[i]
        return out

    n_bh = tree.n_basic + tree.n_house
    return CompiledTree(
        n_basic=tree.n_basic, n_house=tree.n_house, n_gates=tree.n_gates,
        basic_index=_remap_index(tree.basic_index),
        house_index=_remap_index(tree.house_index),
        gate_index=_remap_index(tree.gate_index),
        levels=new_levels,
        basic_events=_permute_list(tree.basic_events, 0),
        house_events=tree.house_events,
        gates=_permute_list(tree.gates, n_bh),
        top_index=(int(perm[tree.top_index])
                   if tree.top_index is not None else None))


def _block_row_ranges(tree: CompiledTree):
    """Per block: (slot range start, row->slot array)."""
    for _, block in _iter_blocks(tree):
        yield int(block.out_idx[0]), block


def _consumer_scores(tree: CompiledTree, pos: np.ndarray) -> np.ndarray:
    """Mean consumer position per node (nodes with no consumers keep
    their own position)."""
    acc = np.zeros(tree.n_nodes)
    cnt = np.zeros(tree.n_nodes)
    for _, block in _iter_blocks(tree):
        rows, cols = _masked_edges(block)
        gate_pos = pos[block.out_idx.astype(np.int64)]
        np.add.at(acc, cols, gate_pos[rows])
        np.add.at(cnt, cols, 1.0)
    scores = pos.astype(np.float64).copy()
    used = cnt > 0
    scores[used] = acc[used] / cnt[used]
    return scores


def _arg_scores(block, pos: np.ndarray) -> np.ndarray:
    """Mean argument position per gate row of a block."""
    rows, cols = _masked_edges(block)
    acc = np.zeros(block.n_gates)
    cnt = np.zeros(block.n_gates)
    np.add.at(acc, rows, pos[cols])
    np.add.at(cnt, rows, 1.0)
    cnt = np.maximum(cnt, 1.0)
    return acc / cnt


def _perm_from_scores(tree: CompiledTree,
                      scores: np.ndarray) -> np.ndarray:
    """Scores -> a constraint-respecting permutation: basics sorted by
    score; each block's rows sorted by score within the block's range;
    houses fixed."""
    perm = np.arange(tree.n_nodes, dtype=np.int64)
    order_b = np.argsort(scores[:tree.n_basic], kind="stable")
    perm[order_b] = np.arange(tree.n_basic)
    for start, block in _block_row_ranges(tree):
        out = block.out_idx.astype(np.int64)
        order = np.argsort(scores[out], kind="stable")
        perm[out[order]] = start + np.arange(len(out))
    return perm


_UNSEEN = np.int64(1) << 62


def _first_use_perm(tree: CompiledTree) -> np.ndarray:
    """Vectorized DFS-order permutation (see module docstring).

    Levels top-down; a node's key is ``new_slot(first consumer) * K +
    argument position`` minimized over consumers — first-use order.  For
    a tree this equals depth-first subtree order restricted to each
    level's slot range.
    """
    max_fan = 1
    for _, block in _iter_blocks(tree):
        max_fan = max(max_fan, block.arg_idx.shape[1])
    K = np.int64(max_fan + 1)

    key = np.full(tree.n_nodes, _UNSEEN, dtype=np.int64)
    perm = np.arange(tree.n_nodes, dtype=np.int64)

    # Per level (top to bottom): order rows by current key, assign new
    # slots, then propagate first-use keys to arguments.
    for level in reversed(tree.levels):
        for _, block in level.iter_blocks():
            if not block.n_gates:
                continue
            out = block.out_idx.astype(np.int64)
            start = int(out[0])
            order = np.argsort(key[out], kind="stable")
            new_slot_of_row = np.empty(len(out), dtype=np.int64)
            new_slot_of_row[order] = start + np.arange(len(out))
            perm[out] = new_slot_of_row

            G, F = block.arg_idx.shape
            rows, cols = _masked_edges(block)
            # Column position of each surviving edge within its row:
            flat_j = np.tile(np.arange(F, dtype=np.int64), G)
            if isinstance(block, PairBlock):
                keep = np.ones(2 * G, dtype=bool)
            else:
                keep = block.arg_mask.reshape(-1)
            flat_j = flat_j[keep]
            cand = new_slot_of_row[rows] * K + flat_j
            np.minimum.at(key, cols, cand)

    order_b = np.argsort(key[:tree.n_basic], kind="stable")
    perm[order_b] = np.arange(tree.n_basic)
    return perm


def _rcm_perm(tree: CompiledTree) -> np.ndarray:
    """Reverse-Cuthill-McKee ranks on the symmetrized gate adjacency,
    projected onto the block constraints (bandwidth-minimizing; the
    better fit for *banded* overlap structures where subtree nesting
    does not exist)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows_l, cols_l = [], []
    for _, block in _iter_blocks(tree):
        rows, cols = _masked_edges(block)
        rows_l.append(block.out_idx.astype(np.int64)[rows])
        cols_l.append(cols)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    n = tree.n_nodes
    adj = sp.coo_matrix((np.ones(len(rows), dtype=np.float32),
                         (rows, cols)), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    order = reverse_cuthill_mckee(adj, symmetric_mode=True)  # new -> old
    rank = np.empty(n, dtype=np.float64)
    rank[order] = np.arange(n)
    return _perm_from_scores(tree, rank)


def _consumer_counts(tree: CompiledTree) -> np.ndarray:
    counts = np.zeros(tree.n_nodes, dtype=np.int64)
    for _, block in _iter_blocks(tree):
        _, cols = _masked_edges(block)
        np.add.at(counts, cols, 1)
    return counts


def _hot_first_perm(tree: CompiledTree, threshold: int = 2) -> np.ndarray:
    """Stable-group multi-consumer ("hot") basic events at the front of
    the basics range.

    Shared events are referenced from chunks all over the matrix;
    first-use placement puts each next to ONE consumer and leaves every
    other reference far away, inflating the block-gather kernel's
    per-chunk DMA spans.  Pulling them into a compact leading region
    lets a handful of resident slabs cover all of them, so the
    remaining (single-consumer) arguments keep their tight DFS ranges.
    Gates are NOT moved: relocating a gate for its consumers' benefit
    scatters its own argument range (measured: spans get worse)."""
    counts = _consumer_counts(tree)
    cold = (counts[:tree.n_basic] < threshold).astype(np.int8)
    perm = np.arange(tree.n_nodes, dtype=np.int64)
    order_b = np.argsort(cold, kind="stable")
    perm[order_b] = np.arange(tree.n_basic)
    return perm


def _flip_group_perm(tree: CompiledTree) -> np.ndarray:
    """Within each block, stable-group gates by flip majority.

    The BSR engine doubles the column space (``log v`` vs ``log(1-v)``
    halves); a row block mixing AND and OR gates touches both halves and
    doubles its tile count.  Grouping by flip majority (stable, so the
    locality order survives within each group) removes that doubling —
    measured ~20-25 % fill reduction on hierarchical models."""
    perm = np.arange(tree.n_nodes, dtype=np.int64)
    for _, block in _iter_blocks(tree):
        out = block.out_idx.astype(np.int64)
        if isinstance(block, ProdBlock):
            flips = (block.arg_flip & block.arg_mask).sum(axis=1)
            majority = flips * 2 >= block.arg_mask.sum(axis=1)
        else:
            majority = np.zeros(len(out), dtype=bool)
        order = np.argsort(majority.astype(np.int8), kind="stable")
        perm[out[order]] = out[0] + np.arange(len(out))
    return perm


def locality_reorder(tree: CompiledTree, sweeps: int = 0,
                     method: str = "first_use",
                     group_flips: bool = False,
                     hot_first: bool = False) -> ReorderedTree:
    """Reorder ``tree`` for argument locality.

    ``method``:

    * ``"first_use"`` (default) — the DFS-order pass; reconstructs
      subtree contiguity exactly on tree-like models (the real-plant
      shape) and is pure numpy.
    * ``"rcm"`` — projected reverse Cuthill-McKee (scipy); wins on
      banded overlap structures with no subtree nesting.
    * ``"auto"`` — evaluate both by estimated BSR fill, keep the lower.

    ``sweeps`` barycenter refinement sweeps follow (each one downward
    consumer pass + one upward argument pass).  Default 0: measured on
    shuffled hierarchical models, barycenter sweeps *regress* the
    first-use ordering (mean-based scores collapse nested structure);
    they are kept for banded/irregular graphs where they can help.

    ``group_flips`` appends the flip-majority grouping pass (see
    :func:`_flip_group_perm`) — a ~20 % BSR-fill win but it interleaves
    subtree runs and inflates the block-gather kernel's DMA spans ~18x
    (measured), so it is opt-in for BSR users only.  ``hot_first``
    applies the multi-consumer grouping pass right after the base
    ordering (see :func:`_hot_first_perm`) — required by the
    block-gather kernel's resident-slab scheme.

    Results of propagation are bit-identical to the input tree (see
    module docstring); only slot numbering — and therefore BSR fill,
    HBM gather locality, and partition balance — changes.
    """
    if method == "auto":
        from ..ops.bsr_propagate import estimate_bsr_fill

        candidates = [locality_reorder(tree, sweeps=sweeps, method=m,
                                       group_flips=group_flips,
                                       hot_first=hot_first)
                      for m in ("first_use", "rcm")]
        return min(candidates,
                   key=lambda r: estimate_bsr_fill(r.tree))
    if method == "rcm":
        perm = _rcm_perm(tree)
    elif method == "first_use":
        perm = _first_use_perm(tree)
    else:
        raise ValueError(f"unknown reorder method: {method!r}")
    current = apply_permutation(tree, perm)
    total_perm = perm

    if hot_first:
        perm = _hot_first_perm(current)
        current = apply_permutation(current, perm)
        total_perm = perm[total_perm]

    for _ in range(max(sweeps, 0)):
        # Downward: nodes follow their consumers.
        pos = np.arange(current.n_nodes, dtype=np.float64)
        scores = _consumer_scores(current, pos)
        perm = _perm_from_scores(current, scores)
        current = apply_permutation(current, perm)
        total_perm = perm[total_perm]

        # Upward: each level's gates follow their (now-final) arguments,
        # bottom-up so lower levels settle first.
        pos = np.arange(current.n_nodes, dtype=np.float64)
        scores = pos.copy()
        for _, block in _iter_blocks(current):  # Levels are bottom-up.
            out = block.out_idx.astype(np.int64)
            scores[out] = _arg_scores(block, scores)
        perm = _perm_from_scores(current, scores)
        current = apply_permutation(current, perm)
        total_perm = perm[total_perm]

    if group_flips:
        perm = _flip_group_perm(current)
        current = apply_permutation(current, perm)
        total_perm = perm[total_perm]
    return ReorderedTree(tree=current, perm=total_perm)


def random_shuffle(tree: CompiledTree, seed: int = 0) -> ReorderedTree:
    """A random constraint-respecting permutation (test/bench adversary:
    models whatever locality-destroying slot assignment an input format
    imposes)."""
    rng = np.random.default_rng(seed)
    perm = np.arange(tree.n_nodes, dtype=np.int64)
    perm[:tree.n_basic] = rng.permutation(tree.n_basic)
    for start, block in _block_row_ranges(tree):
        out = block.out_idx.astype(np.int64)
        perm[out] = start + rng.permutation(len(out))
    return ReorderedTree(tree=apply_permutation(tree, perm), perm=perm)
