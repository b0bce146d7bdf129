"""Alignments and phases (reference ``alignment.h:17-37``, ``phase.h:7-37``).

An alignment partitions the mission time into phases; each phase scales the
mission time by its fraction and may flip house events via
``set-house-event`` instructions. Phase fractions must sum to 1 +- 1e-4.
"""

from __future__ import annotations

import math

from ..errors import ValidityError
from .element import Element, Table
from .instruction import SetHouseEvent


class Phase(Element):
    kind = "phase"

    def __init__(self, name: str, time_fraction: float):
        super().__init__(name)
        if not (0.0 < time_fraction <= 1.0):
            raise ValidityError(
                f"The phase time fraction must be in (0, 1]: {time_fraction}",
                element=name, element_type=self.kind)
        self.time_fraction = time_fraction
        self.instructions: list[SetHouseEvent] = []


class Alignment(Element):
    kind = "alignment"

    def __init__(self, name: str):
        super().__init__(name)
        self.phases: Table[Phase] = Table("phase", by_id=False)

    def add(self, phase: Phase) -> None:
        self.phases.add(phase)

    def validate(self) -> None:
        total = math.fsum(phase.time_fraction for phase in self.phases)
        if abs(total - 1.0) > 1e-4:
            raise ValidityError(
                f"The phases of alignment '{self.name}' must sum to 1 "
                f"(got {total}).", element=self.name, element_type=self.kind)
