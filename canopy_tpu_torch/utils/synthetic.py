"""Synthetic fault-tree generation, at two levels.

* :func:`synthetic_mef_tree` builds real MEF objects (gates/events with
  expressions) — used for golden tests and moderate sizes.
* :func:`synthetic_compiled_tree` builds :class:`CompiledTree` arrays
  directly with numpy — the fast path for benchmark-scale structures
  (1M+ gates) where constructing Python objects would dominate.

Both produce layered DAGs shaped like PRA fault trees: a wide bottom of
basic events, levels of and/or (optionally atleast) gates whose arguments
are drawn from lower levels with locality bias, converging to one top.
"""

from __future__ import annotations

import numpy as np

from ..compiler.graph import (CompiledTree, CountBlock, LevelBlock,
                              PairBlock, ProdBlock)
from ..mef.event import Arg, BasicEvent, Connective, Formula, Gate
from ..mef.expr.constant import ConstantExpression

__all__ = ["synthetic_mef_tree", "synthetic_compiled_tree",
           "synthetic_hierarchical_tree"]


def synthetic_mef_tree(n_basic: int = 60, n_gates: int = 40, fanin: int = 3,
                       seed: int = 0, p_range=(1e-4, 1e-2),
                       atleast_fraction: float = 0.1,
                       complement_fraction: float = 0.05):
    """(top gate, basic events) as real MEF objects.

    Layered PRA shape: alternating OR/AND layers over the previous layer
    (with event sharing), occasional vote gates, complements only under
    AND gates (a complement under a wide OR would trivialize the tree to
    probability ~1), one OR top over all unconsumed roots.
    """
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n_basic):
        log_p = rng.uniform(np.log(p_range[0]), np.log(p_range[1]))
        e = BasicEvent(f"be{i}")
        e.expression = ConstantExpression(float(np.exp(log_p)))
        events.append(e)

    pool: list = list(events)
    gates = []
    for gi in range(n_gates - 1):
        k = int(min(rng.integers(2, fanin + 2), len(pool)))
        chosen = rng.choice(len(pool), size=k, replace=False)
        u = rng.random()
        gate = Gate(f"sg{gi}")
        is_and = u < 0.55
        args = [Arg(pool[int(c)],
                    bool(is_and and rng.random() < complement_fraction))
                for c in chosen]
        if rng.random() < atleast_fraction and k >= 3:
            gate.formula = Formula(Connective.ATLEAST, args, min_number=2)
        elif is_and:
            gate.formula = Formula(Connective.AND, args)
        else:
            gate.formula = Formula(Connective.OR, args)
        gates.append(gate)
        pool.append(gate)

    top = Gate("synthetic-top")
    roots = [g for g in gates if not g.usage] or gates[-2:]
    if len(roots) == 1:
        roots = roots + [gates[0] if gates[0] is not roots[0] else events[0]]
    top.formula = Formula(Connective.OR, [Arg(r) for r in roots])
    return top, events


def synthetic_compiled_tree(n_basic: int = 4096, n_gates: int = 100_000,
                            fanin: int = 4, n_levels: int = 12,
                            seed: int = 0,
                            locality: int | None = None) -> CompiledTree:
    """A benchmark-scale compiled tree (prod-family gates only).

    Levels shrink geometrically toward the top; every gate draws ``fanin``
    arguments from the slots below it (biased toward the previous level,
    the common fault-tree shape). nnz = n_gates * fanin.

    ``locality``: when set, a gate's previous-level arguments come from a
    window of that many slots around its own relative position — the
    subsystem structure of real plant models (components feed the gates
    of their own system). This is the structure the BSR/MXU engine
    exploits; ``None`` = uniform random (worst case for any blocking).
    """
    rng = np.random.default_rng(seed)
    # Geometric level sizes summing to n_gates, last level = 1 (the top).
    raw = np.geomspace(n_gates, 1, n_levels)
    sizes = np.maximum((raw / raw.sum() * (n_gates - 1)).astype(np.int64), 1)
    sizes[-1] = 1
    deficit = n_gates - int(sizes.sum())
    sizes[0] += deficit

    levels = []
    next_slot = n_basic  # No house events.
    prev_level_start = 0
    prev_level_size = n_basic
    for level_size in sizes:
        level_size = int(level_size)
        out_idx = np.arange(next_slot, next_slot + level_size,
                            dtype=np.int32)
        # 70% of edges to the previous level, 30% anywhere below.
        if locality is None:
            local = rng.integers(prev_level_start,
                                 prev_level_start + prev_level_size,
                                 size=(level_size, fanin))
            anywhere = rng.integers(0, next_slot, size=(level_size, fanin))
        else:
            # Window around the gate's relative position (subsystem
            # structure): both previous-level and deep edges stay local.
            centers = (np.arange(level_size, dtype=np.int64)[:, None]
                       * prev_level_size) // max(level_size, 1)
            offsets = rng.integers(-locality // 2, locality // 2 + 1,
                                   size=(level_size, fanin))
            local = prev_level_start + np.clip(
                centers + offsets, 0, prev_level_size - 1)
            deep_centers = (np.arange(level_size, dtype=np.int64)[:, None]
                            * next_slot) // max(level_size, 1)
            anywhere = np.clip(deep_centers + offsets, 0, next_slot - 1)
        pick_local = rng.random((level_size, fanin)) < 0.7
        arg_idx = np.where(pick_local, local, anywhere).astype(np.int32)
        # Alternate and/or gates; no complements on the hot path.
        is_or = (rng.random(level_size) < 0.5)
        arg_flip = np.broadcast_to(is_or[:, None],
                                   (level_size, fanin)).copy()
        inv_out = is_or.copy()
        arg_mask = np.ones((level_size, fanin), dtype=bool)
        levels.append(LevelBlock(
            prods=[ProdBlock(out_idx, arg_idx, arg_flip, arg_mask,
                             inv_out)],
            pairs=[], counts=[]))
        prev_level_start = next_slot
        prev_level_size = level_size
        next_slot += level_size

    return CompiledTree(
        n_basic=n_basic, n_house=0, n_gates=int(sizes.sum()),
        basic_index={f"be{i}": i for i in range(n_basic)},
        house_index={},
        gate_index={f"g{i}": n_basic + i for i in range(int(sizes.sum()))},
        levels=levels, basic_events=[], house_events=[], gates=[],
        top_index=next_slot - 1)


def synthetic_hierarchical_tree(n_basic: int = 65536, branching: int = 4,
                                share_fraction: float = 0.1,
                                n_shared: int = 256,
                                seed: int = 0) -> CompiledTree:
    """A subsystem-hierarchy tree: the structured plant-model shape.

    Level-l gate *i* takes the contiguous block of ``branching`` level-
    (l-1) nodes starting at ``i*branching`` (its subsystem's children);
    with probability ``share_fraction`` one argument is redirected into a
    small shared-event window (common-cause couplings). This is the
    structure the BSR/MXU engine's fill ratio depends on — real plant
    models look like this, uniform-random synthetics do not.
    """
    rng = np.random.default_rng(seed)
    levels = []
    next_slot = n_basic
    prev_start, prev_size = 0, n_basic
    total_gates = 0
    while prev_size > 1:
        level_size = max(prev_size // branching, 1)
        out_idx = np.arange(next_slot, next_slot + level_size,
                            dtype=np.int32)
        base = prev_start + (np.arange(level_size, dtype=np.int64)[:, None]
                             * branching)
        arg_idx = (base + np.arange(branching, dtype=np.int64)[None, :])
        arg_idx = np.minimum(arg_idx, prev_start + prev_size - 1)
        # Shared-event couplings.
        share = rng.random((level_size, branching)) < share_fraction
        shared_targets = rng.integers(0, min(n_shared, n_basic),
                                      size=(level_size, branching))
        arg_idx = np.where(share, shared_targets, arg_idx).astype(np.int32)
        is_or = (np.arange(level_size) % 2 == 0)
        arg_flip = np.broadcast_to(is_or[:, None],
                                   (level_size, branching)).copy()
        inv_out = is_or.copy()
        levels.append(LevelBlock(
            prods=[ProdBlock(out_idx, arg_idx, arg_flip,
                             np.ones((level_size, branching), dtype=bool),
                             inv_out)],
            pairs=[], counts=[]))
        prev_start, prev_size = next_slot, level_size
        next_slot += level_size
        total_gates += level_size
    return CompiledTree(
        n_basic=n_basic, n_house=0, n_gates=total_gates,
        basic_index={f"be{i}": i for i in range(n_basic)},
        house_index={},
        gate_index={f"g{i}": n_basic + i for i in range(total_gates)},
        levels=levels, basic_events=[], house_events=[], gates=[],
        top_index=next_slot - 1)
