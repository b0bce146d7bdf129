"""Minimal cut sets from a BDD (the ZBDD minimal-solutions transform).

Completes the BDD algorithm's qualitative side (reference
``settings.h:13``: bdd/zbdd are the default algorithms; MOCUS is the
fallback generator in ``compiler/cutsets.py``). Rauzy's minimal-solutions
recursion over the ROBDD:

    mcs(0) = {};  mcs(1) = {{}}
    mcs(v ? h : l) = mcs(l)  ∪  { {v} ∪ c : c ∈ mcs(h) ⊖ mcs(l) }

where ``⊖`` removes solutions subsumed by any solution of the low branch
(the "without" set). For monotone (coherent) functions this yields
exactly the minimal cut sets; for non-coherent functions it yields the
minimal solutions with positive literals along high edges (the
minimal-cut-set mode semantics). Full-literal *prime implicants* —
including consensus products — live in
``compiler/prime_implicants.py`` (the Coudert-Madre recursion), which
the analysis dispatches when ``settings.prime_implicants()``.

Truncation by ``limit_order`` happens inside the recursion (solutions are
dropped as soon as they exceed the order bound), so large BDDs with short
cut sets stay cheap.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..errors import LogicError
from .bdd import CompiledBdd

__all__ = ["bdd_minimal_cut_sets"]


def _native_minimal_cut_sets(bdd: CompiledBdd, limit_order: int,
                             max_products: int
                             ) -> tuple[list[frozenset], bool] | None:
    """C++ ZDD minsol path (``native/bdd.cpp``) -> (products, truncated);
    None = unavailable or the ZDD overflowed (caller falls back to the
    Python transform)."""
    from ..native import load_bdd_library

    lib = load_bdd_library()
    if lib is None:
        return None
    var_arr = np.ascontiguousarray(bdd.raw_var, dtype=np.int32)
    low_arr = np.ascontiguousarray(bdd.raw_low, dtype=np.int32)
    high_arr = np.ascontiguousarray(bdd.raw_high, dtype=np.int32)
    root = bdd.resolved_root()
    as_ptr = lambda a: a.ctypes.data_as(  # noqa: E731
        ctypes.POINTER(ctypes.c_int32))
    handle = lib.canopy_minsol(
        as_ptr(var_arr), as_ptr(low_arr), as_ptr(high_arr),
        len(var_arr), int(bdd.n_basic), root, int(limit_order),
        int(max_products), 50_000_000)
    try:
        if lib.canopy_minsol_overflow(handle):
            return None
        truncated = bool(lib.canopy_minsol_truncated(handle))
        n = lib.canopy_minsol_count(handle)
        total = lib.canopy_minsol_total(handle)
        lens = np.zeros(max(int(n), 1), dtype=np.int32)
        flat = np.zeros(max(int(total), 1), dtype=np.int32)
        lib.canopy_minsol_export(handle, as_ptr(lens), as_ptr(flat))
    finally:
        lib.canopy_minsol_free(handle)
    slot_of_var = bdd.slot_of_var
    out: list[frozenset] = []
    offset = 0
    for k in lens[:int(n)]:
        out.append(frozenset(
            (slot_of_var[int(v)], False)
            for v in flat[offset:offset + int(k)]))
        offset += int(k)
    return out, truncated


def bdd_minimal_cut_sets(bdd: CompiledBdd, limit_order: int = 20,
                         use_native: bool | None = None,
                         max_products: int = 2_000_000,
                         with_truncation: bool = False):
    """Minimal products (as frozensets of (basic_slot, False) literals).

    Requires the raw node arrays on the CompiledBdd (``raw_var`` etc.,
    attached by ``build_bdd``).  The native (C++ ZDD) path is used when
    available — the explicit-set Python recursion below is its oracle.

    ``with_truncation=True`` returns ``(products, truncated)`` where
    ``truncated`` reports solutions dropped by ``limit_order`` or the
    ``max_products`` cap.
    """
    if bdd.raw_var is None:
        raise LogicError("CompiledBdd is missing raw node arrays.")
    if use_native is None or use_native:
        native = _native_minimal_cut_sets(bdd, limit_order, max_products)
        if native is not None:
            products, truncated = native
            return (products, truncated) if with_truncation else products
        if use_native:
            raise LogicError("native minsol unavailable or overflowed")
    var_arr, low_arr, high_arr = bdd.raw_var, bdd.raw_low, bdd.raw_high
    slot_of_var = bdd.slot_of_var

    memo: dict[int, list[frozenset]] = {}
    truncated = False

    def subsume(solutions: list[frozenset],
                against: list[frozenset]) -> list[frozenset]:
        return [c for c in solutions
                if not any(a <= c for a in against)]

    def minimize(solutions: list[frozenset]) -> list[frozenset]:
        ordered = sorted(set(solutions), key=len)
        out: list[frozenset] = []
        for candidate in ordered:
            if not any(kept <= candidate for kept in out):
                out.append(candidate)
        return out

    def rec(node: int) -> list[frozenset]:
        if node == 0:
            return []
        if node == 1:
            return [frozenset()]
        found = memo.get(node)
        if found is not None:
            return found
        low_sols = rec(int(low_arr[node]))
        high_sols = rec(int(high_arr[node]))
        literal = (slot_of_var[int(var_arr[node])], False)
        nonlocal truncated
        survivors = subsume(high_sols, low_sols)
        kept = [c for c in survivors if len(c) < limit_order]
        if len(kept) < len(survivors):
            truncated = True
        with_var = [frozenset(c | {literal}) for c in kept]
        result = minimize(low_sols + with_var)
        memo[node] = result
        return result

    # Iterative deepening of the recursion stack is unnecessary: depth is
    # bounded by the variable count, but guard Python's limit anyway.
    import sys
    limit = sys.getrecursionlimit()
    needed = bdd.n_basic + 1000
    if needed > limit:
        sys.setrecursionlimit(needed)
    try:
        products = rec(bdd.resolved_root())
    finally:
        sys.setrecursionlimit(limit)
    return (products, truncated) if with_truncation else products
