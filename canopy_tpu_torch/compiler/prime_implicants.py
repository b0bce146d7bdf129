"""True prime implicants from the ROBDD (Coudert–Madre recursion).

The last Settings capability the reference declares
(``settings.h:77-90``: prime implicants are a BDD-algorithm mode) that
previously had only a stand-in here — MOCUS products with kept negated
literals, which misses *consensus* implicants and can keep non-minimal
products on non-coherent trees.  This module computes the exact prime
implicant set by the classical consensus decomposition (Coudert & Madre
1992; Rauzy & Dutuit 1997):

    PI(f) = PI(f0 ∧ f1)
          ∪  x·(PI(f1) ⊖ PI(f0 ∧ f1))
          ∪ ¬x·(PI(f0) ⊖ PI(f0 ∧ f1))

where x is the top decision variable, f0/f1 its cofactors (the BDD
children), and ``⊖`` removes products subsumed by a consensus product.
The consensus cofactor ``f0 ∧ f1`` needs live BDD conjunction, so the
compiled node arrays are replayed into a forest (the native C++ forest
when available) before the recursion.

``limit_order`` truncation is exact-by-construction: a subsumer is never
longer than the product it subsumes, so dropping products longer than
the limit yields precisely *all prime implicants of length ≤ limit*.
"""

from __future__ import annotations

import sys

from ..errors import LogicError
from .bdd import BddForest, CompiledBdd

__all__ = ["bdd_prime_implicants"]


def _replay_forest(bdd: CompiledBdd, use_native: bool | None = None):
    """Rebuild a live forest from the compiled node arrays.

    Children precede parents by index in the snapshot, so each node is
    one ``ite(var, high, low)``; returns ``(forest, root)``.
    """
    if use_native is None:
        from ..native import native_available
        use_native = native_available()
    if use_native:
        from .bdd import NativeBddForest
        forest = NativeBddForest(bdd.n_basic,
                                 max_nodes=max(4 * len(bdd.raw_var),
                                               1 << 20))
    else:
        forest = BddForest(bdd.n_basic,
                           max_nodes=max(4 * len(bdd.raw_var), 1 << 20))
    root = bdd.resolved_root()
    if root <= 1:
        return forest, root
    var_arr, low_arr, high_arr = bdd.raw_var, bdd.raw_low, bdd.raw_high
    # Only the root cone needs replaying.
    reach: set[int] = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if n <= 1 or n in reach:
            continue
        reach.add(n)
        stack.append(int(low_arr[n]))
        stack.append(int(high_arr[n]))
    mapping = {0: 0, 1: 1}
    for n in sorted(reach):
        mapping[n] = forest.ite(forest.var_node(int(var_arr[n])),
                                mapping[int(high_arr[n])],
                                mapping[int(low_arr[n])])
    return forest, mapping[root]


def bdd_prime_implicants(bdd: CompiledBdd, limit_order: int = 20,
                         max_products: int = 2_000_000,
                         use_native: bool | None = None,
                         with_truncation: bool = False):
    """All prime implicants of length ≤ ``limit_order``.

    Products are frozensets of ``(basic_slot, negated)`` literals — the
    same convention as the cut-set generators, so the quantification
    and report paths consume them unchanged.  Raises ``LogicError``
    when the PI set exceeds ``max_products`` (callers fall back).

    ``with_truncation=True`` returns ``(products, truncated)`` where
    ``truncated`` reports that some prime implicant exceeded
    ``limit_order`` (the returned set is still exactly the primes within
    the limit — see module docstring).
    """
    if bdd.raw_var is None:
        raise LogicError("CompiledBdd is missing raw node arrays.")
    root = bdd.resolved_root()
    if root == 0:
        return ([], False) if with_truncation else []
    if root == 1:
        out = [frozenset()]
        return (out, False) if with_truncation else out
    forest, live_root = _replay_forest(bdd, use_native=use_native)
    slot_of_var = bdd.slot_of_var

    memo: dict[int, list[frozenset]] = {}
    truncated = False
    n_products = 0

    def account(products: list[frozenset]):
        nonlocal n_products
        n_products += len(products)
        if n_products > max_products:
            raise LogicError(
                f"prime-implicant set exceeded {max_products} products")

    def pi(node: int) -> list[frozenset]:
        nonlocal truncated
        if node == 0:
            return []
        if node == 1:
            return [frozenset()]
        found = memo.get(node)
        if found is not None:
            return found
        x = forest.var[node] if isinstance(forest, BddForest) else None
        if x is None:
            # Native forest: node metadata via the snapshot cache below.
            x, f0, f1 = node_meta(node)
        else:
            f0, f1 = forest.low[node], forest.high[node]
        consensus = forest.and_(f0, f1)
        p_c = pi(consensus)
        p_1 = pi(f1)
        p_0 = pi(f0)
        pos = (slot_of_var[x], False)
        neg = (slot_of_var[x], True)
        result = list(p_c)
        for branch, literal in ((p_1, pos), (p_0, neg)):
            for product in branch:
                if any(c <= product for c in p_c):
                    continue
                if len(product) >= limit_order:
                    truncated = True
                    continue
                result.append(frozenset(product | {literal}))
        account(result)
        memo[node] = result
        return result

    if isinstance(forest, BddForest):
        node_meta = None
    else:
        # The native forest grows during and_(); re-snapshot on demand.
        snap = {"var": None, "low": None, "high": None, "n": 0}

        def node_meta(node: int):
            if node >= snap["n"]:
                snap["var"], snap["low"], snap["high"] = forest.snapshot()
                snap["n"] = len(snap["var"])
            return (int(snap["var"][node]), int(snap["low"][node]),
                    int(snap["high"][node]))

    limit = sys.getrecursionlimit()
    needed = 3 * bdd.n_basic + 2000
    if needed > limit:
        sys.setrecursionlimit(needed)
    try:
        products = pi(live_root)
    finally:
        sys.setrecursionlimit(limit)
    return (products, truncated) if with_truncation else products
