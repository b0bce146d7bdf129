"""Constant expressions (reference ``expr/constant.h:13-35``)."""

from __future__ import annotations

import math

from ..expression import Expression


class ConstantExpression(Expression):
    """A literal numeric/boolean constant."""

    tape_op = "const"

    def __init__(self, value: float | int | bool):
        super().__init__()
        self._value = float(value)

    def value(self) -> float:
        return self._value

    def _compute(self) -> float:  # pragma: no cover - value() overridden
        return self._value

    def is_deviate(self) -> bool:
        return False

    def _do_sample(self, rng) -> float:
        return self._value


#: Shared singletons (reference constant.h:33-35).
ONE = ConstantExpression(1.0)
ZERO = ConstantExpression(0.0)
PI = ConstantExpression(math.pi)
