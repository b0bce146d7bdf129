"""Minimal cut set (MOCUS/ZBDD-style) generation.

The qualitative-analysis half of the Settings surface
(``settings.h:13-22``: algorithms bdd/zbdd/mocus/pdag with products bounded
by ``limit_order``/``cut_off``). This is a host-side combinatorial pass —
like the reference's planned design, products are *generated* on the host
and *quantified* on the accelerator: the resulting cut-set matrix is
exactly the CSR operand of the SpMV/SpMM quantification kernels
(``engine/cutset_quantify.py``).

Algorithm: top-down expansion over the formula DAG with

* literal products as sorted tuples of signed basic-event slots,
* `atleast k/n` expanded as OR over k-combinations (its minimal form),
* `cardinality`, `xor`, `iff`, `imply`, `not`, `nand`, `nor` handled by
  De Morgan/Shannon rewriting into positive/negative literals (producing
  prime-implicant-lite products for non-coherent trees),
* truncation by product order (``limit_order``) and probability
  (``cut_off``), and
* minimality by pairwise absorption (subset elimination).

House events fold to their current state during expansion.
"""

from __future__ import annotations

import itertools
from typing import Iterable

from ..errors import LogicError
from ..mef.event import (BasicEvent, Connective, FALSE_EVENT, Formula, Gate,
                         HouseEvent, TRUE_EVENT)
from .graph import CompiledTree

__all__ = ["CutSetGenerator", "Product"]

#: A product is a frozenset of literals; a literal is (basic_slot, is_neg).
Product = frozenset


class _Memo:
    """Per-gate memoized expansion (the DAG is traversed once per gate)."""

    def __init__(self):
        self.positive: dict[int, list[Product]] = {}
        self.negative: dict[int, list[Product]] = {}


class CutSetGenerator:
    """Generates minimal cut sets for a compiled fault tree."""

    def __init__(self, tree: CompiledTree, limit_order: int = 20,
                 cut_off: float = 0.0, probabilities=None):
        self.tree = tree
        self.limit_order = limit_order
        self.cut_off = cut_off
        #: Slot-indexed probabilities for cut-off pruning (optional).
        self.probabilities = probabilities
        self._memo = _Memo()
        #: True when truncation dropped anything (results are a lower
        #: bound on the full product set).
        self.truncated = False

    # -- public API --------------------------------------------------------

    def generate(self, gate: Gate | None = None) -> list[Product]:
        """Minimal products for ``gate`` (default: the tree's top)."""
        if gate is None:
            if self.tree.top_index is None:
                raise LogicError("The compiled tree has no top gate.")
            gate = next(g for g in self.tree.gates
                        if self.tree.gate_index[g.id] == self.tree.top_index)
        products = self._expand_gate(gate, negate=False)
        return self._minimize(products)

    # -- expansion ---------------------------------------------------------

    def _product_prob(self, product: Product) -> float:
        if self.probabilities is None:
            return 1.0
        p = 1.0
        for slot, neg in product:
            q = float(self.probabilities[slot])
            p *= (1.0 - q) if neg else q
        return p

    def _keep(self, product: Product) -> bool:
        if len(product) > self.limit_order:
            self.truncated = True
            return False
        if self.cut_off > 0.0 and self._product_prob(product) < self.cut_off:
            self.truncated = True
            return False
        return True

    def _expand_gate(self, gate: Gate, negate: bool) -> list[Product]:
        memo = self._memo.negative if negate else self._memo.positive
        if id(gate) in memo:
            return memo[id(gate)]
        result = self._expand_formula(gate.formula, negate)
        memo[id(gate)] = result
        return result

    def _literal(self, event: BasicEvent, neg: bool) -> list[Product] | None:
        """Products for a single basic-event literal; None for constants."""
        if event.has_ccf and \
                event.ccf_gate.id in self.tree.gate_index:
            return self._expand_gate(event.ccf_gate, neg)
        slot = self.tree.basic_index.get(event.id)
        if slot is None:
            raise LogicError(f"Basic event '{event.id}' is not in the "
                             "compiled tree.")
        return [frozenset([(slot, neg)])]

    def _arg_products(self, arg, negate: bool) -> list[Product] | str:
        """Products of one formula argument; 'true'/'false' for constants."""
        neg = arg.complement != negate
        event = arg.event
        if isinstance(event, HouseEvent):
            state = event.state
            if event is TRUE_EVENT:
                state = True
            elif event is FALSE_EVENT:
                state = False
            value = state != neg
            return "true" if value else "false"
        if isinstance(event, Gate):
            return self._expand_gate(event, neg)
        return self._literal(event, neg)

    @staticmethod
    def _conjoin(a: Product, b: Product) -> Product | None:
        """AND of two products; None when contradictory (x and not-x)."""
        union = a | b
        # Contradiction check: same slot with both polarities.
        slots = {}
        for slot, neg in union:
            if slots.get(slot, neg) != neg:
                return None
            slots[slot] = neg
        return union

    def _and_lists(self, lists: list[list[Product]]) -> list[Product]:
        """Cartesian conjunction with truncation-aware pruning."""
        acc: list[Product] = [frozenset()]
        # Smallest lists first keeps intermediate growth down.
        for products in sorted(lists, key=len):
            nxt: list[Product] = []
            seen: set[Product] = set()
            for left in acc:
                for right in products:
                    combined = self._conjoin(left, right)
                    if combined is None:
                        continue
                    if len(combined) > self.limit_order:
                        self.truncated = True
                        continue
                    if combined not in seen:
                        seen.add(combined)
                        nxt.append(combined)
            acc = nxt
            if not acc:
                return []
        return [p for p in acc if self._keep(p)]

    def _or_lists(self, lists: list[list[Product]]) -> list[Product]:
        out: list[Product] = []
        seen: set[Product] = set()
        for products in lists:
            for p in products:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
        return out

    def _expand_formula(self, formula: Formula, negate: bool) -> list[Product]:
        c = formula.connective
        # Negation rewrites to the dual connective (De Morgan/Shannon).
        if negate:
            c = {Connective.AND: Connective.NAND,
                 Connective.NAND: Connective.AND,
                 Connective.OR: Connective.NOR,
                 Connective.NOR: Connective.OR,
                 Connective.NOT: Connective.NULL,
                 Connective.NULL: Connective.NOT,
                 Connective.XOR: Connective.IFF,
                 Connective.IFF: Connective.XOR}.get(c, c)
            count_negate = c in (Connective.ATLEAST, Connective.CARDINALITY,
                                 Connective.IMPLY)
        else:
            count_negate = False

        if c in (Connective.AND, Connective.NOR):
            polarity = c is Connective.NOR
            lists = []
            for arg in formula.args:
                products = self._arg_products(arg, polarity)
                if products == "false":
                    return []
                if products == "true":
                    continue
                lists.append(products)
            if not lists:
                return [frozenset()]  # Constant true.
            return self._and_lists(lists)

        if c in (Connective.OR, Connective.NAND):
            polarity = c is Connective.NAND
            lists = []
            for arg in formula.args:
                products = self._arg_products(arg, polarity)
                if products == "true":
                    return [frozenset()]
                if products == "false":
                    continue
                lists.append(products)
            return self._or_lists(lists)

        if c in (Connective.NULL, Connective.NOT):
            products = self._arg_products(formula.args[0],
                                          c is Connective.NOT)
            if products == "true":
                return [frozenset()]
            if products == "false":
                return []
            return products

        if c in (Connective.XOR, Connective.IFF):
            a, b = formula.args
            if c is Connective.XOR:
                terms = [[self._arg_products(a, False),
                          self._arg_products(b, True)],
                         [self._arg_products(a, True),
                          self._arg_products(b, False)]]
            else:
                terms = [[self._arg_products(a, False),
                          self._arg_products(b, False)],
                         [self._arg_products(a, True),
                          self._arg_products(b, True)]]
            out_lists = []
            for pair in terms:
                resolved = []
                constant_false = False
                for products in pair:
                    if products == "false":
                        constant_false = True
                        break
                    if products == "true":
                        continue
                    resolved.append(products)
                if constant_false:
                    continue
                out_lists.append(self._and_lists(resolved) if resolved
                                 else [frozenset()])
            return self._or_lists(out_lists)

        if c is Connective.IMPLY:
            a, b = formula.args
            if count_negate:  # not(a -> b) == a and not b
                lists = [self._arg_products(a, False),
                         self._arg_products(b, True)]
                resolved = [p for p in lists if p not in ("true", "false")]
                if "false" in lists:
                    return []
                return self._and_lists(resolved) if resolved else [frozenset()]
            lists = [self._arg_products(a, True), self._arg_products(b, False)]
            out = []
            for products in lists:
                if products == "true":
                    return [frozenset()]
                if products == "false":
                    continue
                out.append(products)
            return self._or_lists(out)

        if c is Connective.ATLEAST:
            k = formula.min_number
            n = len(formula.args)
            if count_negate:
                # not atleast(k) == at most k-1 == cardinality [0, k-1].
                return self._cardinality(formula.args, 0, k - 1)
            lists = []
            for combo in itertools.combinations(formula.args, k):
                resolved = []
                constant_false = False
                for arg in combo:
                    products = self._arg_products(arg, False)
                    if products == "false":
                        constant_false = True
                        break
                    if products == "true":
                        continue
                    resolved.append(products)
                if constant_false:
                    continue
                lists.append(self._and_lists(resolved) if resolved
                             else [frozenset()])
            return self._or_lists(lists)

        if c is Connective.CARDINALITY:
            lo, hi = formula.min_number, formula.max_number
            if count_negate:
                # not(lo <= X <= hi) == X <= lo-1 or X >= hi+1.
                lists = []
                if lo > 0:
                    lists.append(self._cardinality(formula.args, 0, lo - 1))
                if hi < len(formula.args):
                    lists.append(self._cardinality(formula.args, hi + 1,
                                                   len(formula.args)))
                return self._or_lists(lists)
            return self._cardinality(formula.args, lo, hi)

        raise LogicError(f"Unsupported connective for cut sets: {c}")

    def _cardinality(self, args, lo: int, hi: int) -> list[Product]:
        """OR over exact-count terms: each term fixes which args are true."""
        n = len(args)
        lists = []
        for k in range(max(lo, 0), min(hi, n) + 1):
            for true_set in itertools.combinations(range(n), k):
                true_idx = set(true_set)
                resolved = []
                constant_false = False
                for i, arg in enumerate(args):
                    products = self._arg_products(arg, i not in true_idx)
                    if products == "false":
                        constant_false = True
                        break
                    if products == "true":
                        continue
                    resolved.append(products)
                if constant_false:
                    continue
                lists.append(self._and_lists(resolved) if resolved
                             else [frozenset()])
        return self._or_lists(lists)

    # -- minimization ------------------------------------------------------

    @staticmethod
    def _minimize(products: Iterable[Product]) -> list[Product]:
        """Remove non-minimal products (absorption law)."""
        by_size = sorted(set(products), key=len)
        minimal: list[Product] = []
        for candidate in by_size:
            if any(kept <= candidate for kept in minimal):
                continue
            minimal.append(candidate)
        return minimal
