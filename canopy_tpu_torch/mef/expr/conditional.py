"""Conditional expressions (reference ``expr/conditional.h:13-83``)."""

from __future__ import annotations

from ..expression import Expression, Interval


class Ite(Expression):
    """If-then-else ternary over expressions."""

    tape_op = "ite"

    def __init__(self, condition: Expression, then_expr: Expression,
                 else_expr: Expression):
        super().__init__([condition, then_expr, else_expr])

    def _compute(self, cond, then_v, else_v):
        return then_v if cond else else_v

    def interval(self) -> Interval:
        then_iv = self.args[1].interval()
        else_iv = self.args[2].interval()
        return Interval.closed(min(then_iv.lower, else_iv.lower),
                               max(then_iv.upper, else_iv.upper))


class Switch(Expression):
    """Multi-case selection with a default.

    ``cases`` is a list of (condition, value) expression pairs; the first
    true condition selects its value, otherwise the default applies.
    """

    tape_op = "switch"

    def __init__(self, cases: list[tuple[Expression, Expression]],
                 default: Expression):
        args: list[Expression] = []
        for cond, val in cases:
            args.extend((cond, val))
        args.append(default)
        super().__init__(args)
        self.cases = cases
        self.default = default

    def _compute(self, *values):
        n_cases = len(self.cases)
        for i in range(n_cases):
            if values[2 * i]:
                return values[2 * i + 1]
        return values[-1]

    def interval(self) -> Interval:
        intervals = [val.interval() for _, val in self.cases]
        intervals.append(self.default.interval())
        return Interval.closed(min(iv.lower for iv in intervals),
                               max(iv.upper for iv in intervals))
