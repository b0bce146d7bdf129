"""Events, gates, and formulas — the Boolean structure of fault trees.

Capability parity with the reference event layer
(``reference/src/mef/openpsa/event/event.h:22-166``,
``event/gate.h:31-65``, ``event/event.cpp:35-204``): the :class:`Connective`
enumeration (ordered to match the analysis layer), house/basic events,
gates, and :class:`Formula` with the full arity/nesting validation battery.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

from ..errors import (DuplicateElementError, LogicError, ValidityError)
from .element import Element, RoleSpecifier
from .expression import Expression, ensure_probability


class Connective(enum.IntEnum):
    """Formula connectives, ordered as in the reference (event.h:143-166)."""

    AND = 0
    OR = 1
    ATLEAST = 2  # K/N (vote) gate.
    XOR = 3      # Exactly two arguments.
    NOT = 4
    NAND = 5
    NOR = 6
    NULL = 7     # Single-argument pass-through.
    IFF = 8      # Equality, two arguments.
    IMPLY = 9    # Implication, two arguments.
    CARDINALITY = 10  # min <= true-count <= max.


CONNECTIVE_NAMES = ["and", "or", "atleast", "xor", "not", "nand", "nor",
                    "null", "iff", "imply", "cardinality"]
CONNECTIVE_BY_NAME = {name: Connective(i)
                      for i, name in enumerate(CONNECTIVE_NAMES)}


class Event(Element):
    """Abstract base for all event kinds."""

    kind = "event"


class HouseEvent(Event):
    """A Boolean constant event (reference event.h:60-85)."""

    kind = "house event"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC,
                 state: bool = False):
        super().__init__(name, base_path, role)
        self.state = state


#: Singleton constants for formula constant arguments (event.cpp:16-23).
TRUE_EVENT = HouseEvent("__true__", state=True)
FALSE_EVENT = HouseEvent("__false__", state=False)


class BasicEvent(Event):
    """A primary failure event with a probability expression."""

    kind = "basic event"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        self.expression: Optional[Expression] = None
        #: Proxy gate if this event is expanded by a CCF group.
        self.ccf_gate: Optional["Gate"] = None

    @property
    def has_expression(self) -> bool:
        return self.expression is not None

    def p(self) -> float:
        """The mean probability (reference event.h:93-96)."""
        if self.expression is None:
            raise LogicError(f"Basic event '{self.id}' has no expression.")
        return self.expression.value()

    @property
    def has_ccf(self) -> bool:
        return self.ccf_gate is not None

    def validate(self) -> None:
        ensure_probability(self.expression, f"probability of '{self.id}'")


ArgEvent = Union["Gate", BasicEvent, HouseEvent]


class Arg:
    """A (possibly complemented) formula argument."""

    __slots__ = ("complement", "event")

    def __init__(self, event: ArgEvent, complement: bool = False):
        self.event = event
        self.complement = complement


class Formula:
    """A Boolean formula: a connective over a set of event arguments.

    Enforces the reference validation battery (event.cpp:140-204):

    * and/or/nand/nor take >= 2 arguments; not/null exactly 1;
      xor/iff/imply exactly 2.
    * atleast requires ``min_number >= 2`` and strictly more arguments
      than ``min_number``.
    * cardinality requires ``0 <= min <= max <= len(args)`` and at least
      one argument.
    * duplicate arguments (by id) are rejected;
    * complement args cannot nest under not/null; constants cannot nest
      under not.
    """

    def __init__(self, connective: Connective, args: list[Arg],
                 min_number: int | None = None, max_number: int | None = None):
        self.connective = connective
        self.args: list[Arg] = []
        self._min_number = min_number
        self._max_number = max_number
        for arg in args:
            self._add(arg)
        self._validate_min_max(min_number, max_number)
        self._validate_connective(min_number, max_number)
        for arg in self.args:
            self._validate_nesting(arg)

    # -- arg management ----------------------------------------------------
    def _add(self, arg: Arg) -> None:
        if any(existing.event.id == arg.event.id for existing in self.args):
            raise DuplicateElementError(arg.event.id)
        self.args.append(arg)
        if not arg.event.usage:
            arg.event.usage = True

    def remove(self, event: ArgEvent) -> None:
        for i, arg in enumerate(self.args):
            if arg.event is event:
                del self.args[i]
                return
        raise LogicError("The event is not in the argument set.")

    def swap(self, current: ArgEvent, other: ArgEvent) -> None:
        """Replace ``current`` with ``other`` (used by substitutions)."""
        target = None
        for arg in self.args:
            if arg.event is current:
                target = arg
                break
        if target is None:
            raise LogicError("The current event is not in the formula.")
        if any(arg.event is not current and arg.event.id == other.id
               for arg in self.args):
            raise DuplicateElementError(other.id)
        self._validate_nesting(Arg(other, target.complement))
        if not other.usage:
            other.usage = True
        target.event = other

    # -- numbers -----------------------------------------------------------
    @property
    def min_number(self) -> int | None:
        if self.connective in (Connective.ATLEAST, Connective.CARDINALITY):
            return self._min_number
        return None

    @property
    def max_number(self) -> int | None:
        if self.connective is Connective.CARDINALITY:
            return self._max_number
        return None

    # -- validation --------------------------------------------------------
    def _validate_min_max(self, min_number, max_number) -> None:
        if min_number is not None:
            if min_number < 0:
                raise LogicError(
                    f"The min number cannot be negative: {min_number}")
            if self.connective not in (Connective.ATLEAST,
                                       Connective.CARDINALITY):
                raise LogicError(
                    "The min number can only be defined for 'atleast' or "
                    f"'cardinality': {CONNECTIVE_NAMES[self.connective]}")
        if max_number is not None:
            if max_number < 0:
                raise LogicError(
                    f"The max number cannot be negative: {max_number}")
            if self.connective is not Connective.CARDINALITY:
                raise LogicError(
                    "The max number can only be defined for 'cardinality': "
                    f"{CONNECTIVE_NAMES[self.connective]}")
            if min_number is not None and min_number > max_number:
                raise ValidityError(
                    "The connective min number cannot be greater than max "
                    f"number: {min_number} > {max_number}")

    def _validate_connective(self, min_number, max_number) -> None:
        n = len(self.args)
        c = self.connective
        if c in (Connective.AND, Connective.OR, Connective.NAND,
                 Connective.NOR):
            if n < 2:
                raise ValidityError(
                    f"'{CONNECTIVE_NAMES[c]}' must have 2 or more arguments.")
        elif c in (Connective.NOT, Connective.NULL):
            if n != 1:
                raise ValidityError(
                    f"'{CONNECTIVE_NAMES[c]}' must have only one argument.")
        elif c in (Connective.XOR, Connective.IFF, Connective.IMPLY):
            if n != 2:
                raise ValidityError(
                    f"'{CONNECTIVE_NAMES[c]}' must have exactly 2 arguments.")
        elif c is Connective.ATLEAST:
            if min_number is None:
                raise ValidityError(
                    "'atleast' requires a min number for its arguments.")
            if min_number < 2:
                raise ValidityError(
                    f"'atleast' min number cannot be less than 2: {min_number}")
            if n <= min_number:
                raise ValidityError(
                    "'atleast' must have more arguments than its min number: "
                    f"{n} <= {min_number}")
        elif c is Connective.CARDINALITY:
            if min_number is None or max_number is None:
                raise ValidityError(
                    "'cardinality' requires min and max numbers for its "
                    "arguments.")
            if n == 0:
                raise ValidityError(
                    "'cardinality' requires one or more arguments.")
            if n < max_number:
                raise ValidityError(
                    "'cardinality' max number cannot be greater than the "
                    f"number of arguments: {max_number} > {n}")

    def _validate_nesting(self, arg: Arg) -> None:
        if arg.complement and self.connective in (Connective.NULL,
                                                  Connective.NOT):
            raise LogicError("Invalid nesting of a complement arg.")
        if self.connective is Connective.NOT and arg.event in (TRUE_EVENT,
                                                               FALSE_EVENT):
            raise LogicError("Invalid nesting of a constant arg.")


class Gate(Event):
    """A named intermediate event owning a formula (reference gate.h:31-65)."""

    kind = "gate"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        self.formula: Optional[Formula] = None

    @property
    def has_formula(self) -> bool:
        return self.formula is not None
