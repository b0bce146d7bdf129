"""A reduced ordered BDD of a coherent fault tree, written plainly.

Nodes are integers: 0 and 1 are the terminals, node ``n >= 2`` is
``(var[n], low[n], high[n])``.  Variables are ranked by their first
appearance in a depth-first walk from the top.  ``and``/``or`` apply with
memo tables; ``atleast k`` expands as ``at(k, i) = at(k, i + 1) or (x_i
and at(k - 1, i + 1))``.  Negation is refused: the fault trees judged
here are coherent.

The top's probability on a batch of basic-event probabilities is the
Shannon sum over the nodes, bottom variable first.
"""

from __future__ import annotations

import sys

import torch

from .mef import Model, UnsupportedModel, _children

__all__ = ["Bdd", "build_bdd", "evaluate"]


class Bdd:
    def __init__(self, order: list[str]):
        self.order = order                  # rank -> basic event name
        self.var = [len(order), len(order)]  # terminals rank last
        self.low = [0, 1]
        self.high = [0, 1]
        self._unique: dict = {}
        self._memo: dict = {}
        self.root = 0

    def node(self, v: int, lo: int, hi: int) -> int:
        if lo == hi:
            return lo
        key = (v, lo, hi)
        n = self._unique.get(key)
        if n is None:
            n = len(self.var)
            self.var.append(v)
            self.low.append(lo)
            self.high.append(hi)
            self._unique[key] = n
        return n

    def apply(self, op: str, f: int, g: int) -> int:
        if op == "and":
            if f == 0 or g == 0:
                return 0
            if f == 1:
                return g
            if g == 1 or f == g:
                return f
        else:
            if f == 1 or g == 1:
                return 1
            if f == 0:
                return g
            if g == 0 or f == g:
                return f
        if f > g:
            f, g = g, f
        key = (op, f, g)
        out = self._memo.get(key)
        if out is not None:
            return out
        vf, vg = self.var[f], self.var[g]
        v = min(vf, vg)
        f0, f1 = (self.low[f], self.high[f]) if vf == v else (f, f)
        g0, g1 = (self.low[g], self.high[g]) if vg == v else (g, g)
        out = self.node(v, self.apply(op, f0, g0), self.apply(op, f1, g1))
        self._memo[key] = out
        return out


def build_bdd(model: Model, top: str) -> Bdd:
    """The BDD of gate ``top``."""
    order, seen = [], set()

    def walk(f):
        stack = [f]
        visited = set()
        while stack:
            f = stack.pop()
            if f[0] == "gate":
                if f[1] in visited:
                    continue
                visited.add(f[1])
                stack.append(model.gates[f[1]])
            elif f[0] == "basic":
                if f[1] not in seen:
                    seen.add(f[1])
                    order.append(f[1])
            elif f[0] == "not":
                raise UnsupportedModel("negation in a fault tree")
            else:
                stack.extend(reversed(_children(f)))

    walk(("gate", top))
    bdd = Bdd(order)
    rank = {name: i for i, name in enumerate(order)}
    gate_bdd: dict[str, int] = {}

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 20000))
    try:
        def build(f) -> int:
            kind = f[0]
            if kind == "basic":
                return bdd.node(rank[f[1]], 0, 1)
            if kind == "gate":
                n = gate_bdd.get(f[1])
                if n is None:
                    n = gate_bdd[f[1]] = build(model.gates[f[1]])
                return n
            args = [build(c) for c in _children(f)]
            if kind in ("and", "or"):
                out = 1 if kind == "and" else 0
                for a in args:
                    out = bdd.apply(kind, out, a)
                return out
            k = f[1]
            # at[j] = at least j of the arguments from i on, for j <= k.
            at = [1] + [0] * k
            for a in reversed(args):
                at = [1] + [bdd.apply("or", at[j],
                                      bdd.apply("and", a, at[j - 1]))
                            for j in range(1, k + 1)]
            return at[k]

        bdd.root = build(("gate", top))
    finally:
        sys.setrecursionlimit(limit)
    bdd._memo.clear()
    return bdd


def _levels(bdd: Bdd):
    """Reachable nodes grouped by variable, deepest variable first:
    ``[(var, nodes, lows, highs)]`` as lists."""
    by_var: dict[int, list[int]] = {}
    seen, stack = set(), [bdd.root]
    while stack:
        n = stack.pop()
        if n > 1 and n not in seen:
            seen.add(n)
            by_var.setdefault(bdd.var[n], []).append(n)
            stack += [bdd.low[n], bdd.high[n]]
    return [(v, nodes, [bdd.low[n] for n in nodes],
             [bdd.high[n] for n in nodes])
            for v, nodes in sorted(by_var.items(), reverse=True)]


def evaluate(bdd: Bdd, p: torch.Tensor, columns: list[int],
             dtype: torch.dtype = torch.float64,
             chunk: int = 1 << 16) -> torch.Tensor:
    """P(top) for each row of ``p`` (rows, basic events), computed in
    ``dtype``: ``columns[rank]`` is the column of the variable of that
    rank.  Rows go ``chunk`` at a time."""
    levels = _levels(bdd)
    if bdd.root <= 1:
        return torch.full((p.shape[0],), float(bdd.root), dtype=dtype,
                          device=p.device)
    nodes = sorted(n for _v, ns, _l, _h in levels for n in ns)
    index = {0: 0, 1: 1}
    for i, n in enumerate(nodes):
        index[n] = i + 2
    dev = p.device
    plan = [(columns[v],
             torch.tensor([index[n] for n in ns], device=dev),
             torch.tensor([index[n] for n in lo], device=dev),
             torch.tensor([index[n] for n in hi], device=dev))
            for v, ns, lo, hi in levels]
    out = []
    for r0 in range(0, p.shape[0], chunk):
        block = p[r0:r0 + chunk].to(dtype)
        vals = torch.zeros((len(nodes) + 2, block.shape[0]), dtype=dtype,
                           device=dev)
        vals[1] = 1
        for col, ns, lo, hi in plan:
            q = block[:, col]
            vals[ns] = q * vals[hi] + (1 - q) * vals[lo]
        # A copy, not a view: each chunk's node values are freed at once.
        out.append(vals[index[bdd.root]].clone())
    return torch.cat(out)
