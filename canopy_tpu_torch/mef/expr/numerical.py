"""Numerical expressions (reference ``expr/numerical.h:41-205``).

Each class is a thin declarative node: ``tape_op`` names the vectorized JAX
op used by the tape compiler; ``_compute`` provides the scalar oracle used
for validation and host-side golden checks. ``validate`` reproduces the
reference's domain checks (div-by-zero, acos/asin range, log positivity,
mod/pow zero rules, sqrt non-negativity: ``numerical.h:106-174``) and
``interval`` reproduces the corner-evaluation interval propagation, with the
reference's special cases for periodic/trig functions.
"""

from __future__ import annotations

import math
from functools import reduce

from ...errors import DomainError, ValidityError
from ..expression import (Expression, Interval, corner_interval,
                          ensure_non_negative, ensure_within)


class _Nary(Expression):
    """Base for n-ary numerical expressions with corner-interval propagation."""

    #: (min_args, max_args); None = unbounded.
    arity: tuple[int, int | None] = (1, None)
    tape_op = ""

    def __init__(self, args):
        super().__init__(args)
        lo, hi = self.arity
        n = len(self.args)
        if n < lo or (hi is not None and n > hi):
            raise ValidityError(
                f"'{type(self).__name__.lower()}' expression requires "
                f"{'exactly ' + str(lo) if lo == hi else 'at least ' + str(lo)}"
                f" argument(s), got {n}.")

    def interval(self) -> Interval:
        return corner_interval(self._compute, [a.interval() for a in self.args])


class Neg(_Nary):
    arity = (1, 1)
    tape_op = "neg"

    def _compute(self, x):
        return -x


class Add(_Nary):
    arity = (2, None)
    tape_op = "add"

    def _compute(self, *xs):
        return math.fsum(xs)


class Sub(_Nary):
    arity = (2, None)
    tape_op = "sub"

    def _compute(self, first, *rest):
        return first - math.fsum(rest)


class Mul(_Nary):
    arity = (2, None)
    tape_op = "mul"

    def _compute(self, *xs):
        return reduce(lambda a, b: a * b, xs, 1.0)


class Div(_Nary):
    arity = (2, None)
    tape_op = "div"

    def _compute(self, first, *rest):
        return reduce(lambda a, b: a / b, rest, first)

    def validate(self) -> None:
        # No divisor argument may contain 0 (reference numerical.h:106-118).
        for arg in self.args[1:]:
            if arg.value() == 0 or arg.interval().contains(0.0):
                raise DomainError("Division by zero in 'div' expression.")


class Abs(_Nary):
    arity = (1, 1)
    tape_op = "abs"

    def _compute(self, x):
        return abs(x)


class Acos(_Nary):
    arity = (1, 1)
    tape_op = "acos"

    def _compute(self, x):
        return math.acos(x)

    def validate(self) -> None:
        ensure_within(self.args[0], Interval.closed(-1.0, 1.0), "acos")

    def interval(self) -> Interval:
        return Interval.closed(0.0, math.pi)


class Asin(_Nary):
    arity = (1, 1)
    tape_op = "asin"

    def _compute(self, x):
        return math.asin(x)

    def validate(self) -> None:
        ensure_within(self.args[0], Interval.closed(-1.0, 1.0), "asin")

    def interval(self) -> Interval:
        return Interval.closed(-math.pi / 2, math.pi / 2)


class Atan(_Nary):
    arity = (1, 1)
    tape_op = "atan"

    def _compute(self, x):
        return math.atan(x)

    def interval(self) -> Interval:
        return Interval.closed(-math.pi / 2, math.pi / 2)


class Cos(_Nary):
    arity = (1, 1)
    tape_op = "cos"

    def _compute(self, x):
        return math.cos(x)

    def interval(self) -> Interval:
        return Interval.closed(-1.0, 1.0)


class Sin(_Nary):
    arity = (1, 1)
    tape_op = "sin"

    def _compute(self, x):
        return math.sin(x)

    def interval(self) -> Interval:
        return Interval.closed(-1.0, 1.0)


class Tan(_Nary):
    arity = (1, 1)
    tape_op = "tan"

    def _compute(self, x):
        return math.tan(x)


class Cosh(_Nary):
    arity = (1, 1)
    tape_op = "cosh"

    def _compute(self, x):
        return math.cosh(x)


class Sinh(_Nary):
    arity = (1, 1)
    tape_op = "sinh"

    def _compute(self, x):
        return math.sinh(x)


class Tanh(_Nary):
    arity = (1, 1)
    tape_op = "tanh"

    def _compute(self, x):
        return math.tanh(x)


class Exp(_Nary):
    arity = (1, 1)
    tape_op = "exp"

    def _compute(self, x):
        return math.exp(x)


class Log(_Nary):
    arity = (1, 1)
    tape_op = "log"

    def _compute(self, x):
        return math.log(x)

    def validate(self) -> None:
        # Strictly positive domain (numerical.h:140-150).
        arg = self.args[0]
        if arg.value() <= 0 or not arg.interval().is_positive:
            raise DomainError("'log' argument domain must be positive.")


class Log10(_Nary):
    arity = (1, 1)
    tape_op = "log10"

    def _compute(self, x):
        return math.log10(x)

    def validate(self) -> None:
        arg = self.args[0]
        if arg.value() <= 0 or not arg.interval().is_positive:
            raise DomainError("'log10' argument domain must be positive.")


class Mod(_Nary):
    arity = (2, 2)
    tape_op = "mod"

    def _compute(self, x, y):
        # C++ integral % semantics (truncated), applied to rounded ints.
        xi, yi = int(x), int(y)
        return float(math.fmod(xi, yi))

    def validate(self) -> None:
        # The divisor cannot be 0 (numerical.h:152-160).
        divisor = self.args[1]
        if int(divisor.value()) == 0:
            raise DomainError("'mod' divisor cannot be zero.")
        iv = divisor.interval()
        if int(iv.lower) == 0 or int(iv.upper) == 0 or iv.contains(0.0):
            raise DomainError("'mod' divisor domain cannot contain zero.")


class Pow(_Nary):
    arity = (2, 2)
    tape_op = "pow"

    def _compute(self, x, y):
        return math.pow(x, y)

    def validate(self) -> None:
        # 0 base with non-positive exponent is undefined (numerical.h:162-174).
        base, exponent = self.args
        if base.value() == 0 and exponent.value() <= 0:
            raise DomainError("'pow' zero base with non-positive exponent.")
        if base.interval().contains(0.0) and not exponent.interval().is_positive:
            raise DomainError(
                "'pow' base domain contains zero with non-positive exponent domain.")


class Sqrt(_Nary):
    arity = (1, 1)
    tape_op = "sqrt"

    def _compute(self, x):
        return math.sqrt(x)

    def validate(self) -> None:
        ensure_non_negative(self.args[0], "sqrt")


class Ceil(_Nary):
    arity = (1, 1)
    tape_op = "ceil"

    def _compute(self, x):
        return float(math.ceil(x))


class Floor(_Nary):
    arity = (1, 1)
    tape_op = "floor"

    def _compute(self, x):
        return float(math.floor(x))


class Min(_Nary):
    arity = (1, None)
    tape_op = "min"

    def _compute(self, *xs):
        return min(xs)


class Max(_Nary):
    arity = (1, None)
    tape_op = "max"

    def _compute(self, *xs):
        return max(xs)


class Mean(_Nary):
    arity = (2, None)
    tape_op = "mean"

    def _compute(self, *xs):
        return math.fsum(xs) / len(xs)
