"""The root Model container (reference ``model.h:27-165``).

A multi-container over every MEF construct type with cross-type event
lookup, duplicate-ID enforcement across the gate/basic/house namespaces,
the shared mission time, the (single) event-tree walk context, and
ownership of anonymous expressions/instructions.
"""

from __future__ import annotations

from typing import Optional, Union

from ..errors import DuplicateElementError, UndefinedElement
from .alignment import Alignment
from .ccf_group import CcfGroup
from .element import Element, Table
from .event import BasicEvent, Event, Gate, HouseEvent
from .event_tree import EventTree, InitiatingEvent, Sequence
from .expr.extern import ExternFunction, ExternLibrary
from .fault_tree import FaultTree
from .instruction import Instruction, Rule
from .parameter import MissionTime, Parameter
from .substitution import Substitution

#: Sentinel name for models without an explicit name (model.h:41).
DEFAULT_NAME = "__unnamed-model__"


class Context:
    """The current event-tree walk state (model.h:71-76).

    ``initiating_event`` names the walk's initiator; ``functional_events``
    maps functional-event names to their chosen states on the current path.
    """

    def __init__(self):
        self.initiating_event: str = ""
        self.functional_events: dict[str, str] = {}

    def clear(self) -> None:
        self.initiating_event = ""
        self.functional_events.clear()


class Model(Element):
    kind = "model"

    def __init__(self, name: str = ""):
        super().__init__(name or DEFAULT_NAME)
        self.mission_time = MissionTime()
        self.context = Context()

        self.initiating_events: Table[InitiatingEvent] = Table("initiating event")
        self.event_trees: Table[EventTree] = Table("event tree")
        self.sequences: Table[Sequence] = Table("sequence")
        self.rules: Table[Rule] = Table("rule")
        self.alignments: Table[Alignment] = Table("alignment")
        self.substitutions: Table[Substitution] = Table("substitution")
        self.fault_trees: Table[FaultTree] = Table("fault tree")
        self.basic_events: Table[BasicEvent] = Table("basic event")
        self.gates: Table[Gate] = Table("gate")
        self.house_events: Table[HouseEvent] = Table("house event")
        self.parameters: Table[Parameter] = Table("parameter")
        self.ccf_groups: Table[CcfGroup] = Table("CCF group")
        self.libraries: Table[ExternLibrary] = Table("extern library")
        self.extern_functions: Table[ExternFunction] = Table("extern function")

        #: Anonymous expressions/instructions owned by the model
        #: (model.h:159-161).
        self.expressions: list = []
        self.instructions: list[Instruction] = []

    @property
    def has_default_name(self) -> bool:
        return self.name == DEFAULT_NAME

    # -- event namespace ---------------------------------------------------
    def _check_duplicate_event(self, event: Event) -> None:
        """IDs are unique across gates/basic/house events (model.h:151-155)."""
        for table in (self.gates, self.basic_events, self.house_events):
            if event.id in table:
                raise DuplicateElementError(f"event: {event.id}")

    def add_gate(self, gate: Gate) -> Gate:
        self._check_duplicate_event(gate)
        return self.gates.add(gate)

    def add_basic_event(self, event: BasicEvent) -> BasicEvent:
        self._check_duplicate_event(event)
        return self.basic_events.add(event)

    def add_house_event(self, event: HouseEvent) -> HouseEvent:
        self._check_duplicate_event(event)
        return self.house_events.add(event)

    def get_event(self, entity_id: str) -> Union[Gate, BasicEvent, HouseEvent]:
        """Cross-type event lookup (model.h:128-136)."""
        for table in (self.basic_events, self.gates, self.house_events):
            found = table.find(entity_id)
            if found is not None:
                return found
        raise UndefinedElement(entity_id, "event")

    # -- anonymous ownership ----------------------------------------------
    def add_expression(self, expression):
        self.expressions.append(expression)
        return expression

    def add_instruction(self, instruction: Instruction) -> Instruction:
        self.instructions.append(instruction)
        return instruction
