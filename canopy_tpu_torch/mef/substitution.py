"""Substitutions (reference ``substitution.h:19-184``).

A substitution applies its target when the hypothesis (a formula over basic
events only) is satisfied: declarative substitutions (no source events)
constrain the model; non-declarative ones replace the source events with
the target. ``type()`` deduces the equivalent "traditional" type —
delete-terms, recovery-rule, or exchange-event.
"""

from __future__ import annotations

from typing import Optional, Union

from ..errors import DuplicateElementError, ValidityError
from .element import Element
from .event import BasicEvent, Connective, Formula

SUBSTITUTION_TYPES = ["delete-terms", "recovery-rule", "exchange-event"]

#: A substitution target: a basic event or a Boolean constant.
Target = Union[BasicEvent, bool]


class Substitution(Element):
    kind = "substitution"

    def __init__(self, name: str):
        super().__init__(name)
        self._hypothesis: Optional[Formula] = None
        self.source: list[BasicEvent] = []
        self.target: Optional[Target] = None

    @property
    def hypothesis(self) -> Formula:
        assert self._hypothesis is not None, "Hypothesis is not set."
        return self._hypothesis

    @hypothesis.setter
    def hypothesis(self, formula: Formula) -> None:
        self._hypothesis = formula

    @property
    def declarative(self) -> bool:
        return not self.source

    def add_source(self, event: BasicEvent) -> None:
        if any(existing.id == event.id for existing in self.source):
            raise DuplicateElementError(f"source event: {event.id}")
        self.source.append(event)

    def validate(self) -> None:
        """Reference substitution.h:85-127 verbatim semantics."""
        assert self._hypothesis is not None, "Missing substitution hypothesis."
        if any(not isinstance(arg.event, BasicEvent)
               for arg in self.hypothesis.args):
            raise ValidityError(
                "Substitution hypothesis must be built over basic events "
                "only.", element=self.name, element_type=self.kind)
        if any(arg.complement for arg in self.hypothesis.args):
            raise ValidityError("Substitution hypotheses must be coherent.",
                                element=self.name, element_type=self.kind)
        if self.declarative:
            if self.hypothesis.connective not in (
                    Connective.NULL, Connective.AND, Connective.ATLEAST,
                    Connective.OR):
                raise ValidityError(
                    "Substitution hypotheses must be coherent.",
                    element=self.name, element_type=self.kind)
            if self.target is True:
                raise ValidityError("Substitution has no effect.",
                                    element=self.name, element_type=self.kind)
        else:
            if self.hypothesis.connective not in (
                    Connective.NULL, Connective.AND, Connective.OR):
                raise ValidityError(
                    "Non-declarative substitution hypotheses only allow "
                    "AND/OR/NULL connectives.",
                    element=self.name, element_type=self.kind)
            if self.target is False:
                raise ValidityError("Substitution source set is irrelevant.",
                                    element=self.name, element_type=self.kind)

    def type(self) -> Optional[int]:
        """Deduce the traditional type (substitution.h:132-175).

        Returns an index into :data:`SUBSTITUTION_TYPES` or None.
        """
        def in_hypothesis(source_arg: BasicEvent) -> bool:
            return any(arg.event is source_arg for arg in self.hypothesis.args)

        def is_mutually_exclusive(formula: Formula) -> bool:
            if formula.connective is Connective.ATLEAST:
                return formula.min_number == 2
            if formula.connective is Connective.AND:
                return len(formula.args) == 2
            return False

        if not self.source:
            if self.target is False:
                if is_mutually_exclusive(self.hypothesis):
                    return 0  # delete-terms
            elif isinstance(self.target, BasicEvent):
                if self.hypothesis.connective is Connective.AND:
                    return 1  # recovery-rule
            return None
        if not isinstance(self.target, BasicEvent):
            return None
        if self.hypothesis.connective not in (Connective.AND, Connective.NULL):
            return None
        if len(self.source) == len(self.hypothesis.args):
            if all(in_hypothesis(s) for s in self.source):
                return 1  # recovery-rule
        elif len(self.source) == 1:
            if in_hypothesis(self.source[0]):
                return 2  # exchange-event
        return None
