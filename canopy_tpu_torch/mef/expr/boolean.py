"""Boolean expressions over doubles (reference ``expr/boolean.h:13-21``).

Results are 1.0/0.0; truthiness of inputs is C-style (non-zero is true).
"""

from __future__ import annotations

from .numerical import _Nary


class Not(_Nary):
    arity = (1, 1)
    tape_op = "bnot"

    def _compute(self, x):
        return float(not x)


class And(_Nary):
    arity = (2, None)
    tape_op = "band"

    def _compute(self, *xs):
        return float(all(xs))


class Or(_Nary):
    arity = (2, None)
    tape_op = "bor"

    def _compute(self, *xs):
        return float(any(xs))


class Eq(_Nary):
    arity = (2, 2)
    tape_op = "eq"

    def _compute(self, x, y):
        return float(x == y)


class Df(_Nary):
    """Not-equal ("different") comparison."""

    arity = (2, 2)
    tape_op = "df"

    def _compute(self, x, y):
        return float(x != y)


class Lt(_Nary):
    arity = (2, 2)
    tape_op = "lt"

    def _compute(self, x, y):
        return float(x < y)


class Gt(_Nary):
    arity = (2, 2)
    tape_op = "gt"

    def _compute(self, x, y):
        return float(x > y)


class Leq(_Nary):
    arity = (2, 2)
    tape_op = "leq"

    def _compute(self, x, y):
        return float(x <= y)


class Geq(_Nary):
    arity = (2, 2)
    tape_op = "geq"

    def _compute(self, x, y):
        return float(x >= y)
