"""Fault trees and components (reference ``fault_tree.h:19-191``)."""

from __future__ import annotations

from ..errors import ValidityError
from .ccf_group import CcfGroup
from .element import Element, NodeMark, RoleSpecifier, Table
from .event import BasicEvent, Gate, HouseEvent
from .parameter import Parameter


class Component(Element):
    """A scoped container of events/parameters/CCF groups/sub-components.

    Mirrors the reference ``Component`` (fault_tree.h:19-124): role
    inheritance, per-scope duplicate detection, and recursive gate
    gathering.
    """

    kind = "component"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        self.gates: Table[Gate] = Table("gate", by_id=False)
        self.basic_events: Table[BasicEvent] = Table("basic event", by_id=False)
        self.house_events: Table[HouseEvent] = Table("house event", by_id=False)
        self.parameters: Table[Parameter] = Table("parameter", by_id=False)
        self.ccf_groups: Table[CcfGroup] = Table("CCF group", by_id=False)
        self.components: Table["Component"] = Table("component", by_id=False)

    # Scope-level duplicate detection: events share one namespace within a
    # component (fault_tree.h:40-77).
    def _check_event_name(self, name: str) -> None:
        for table in (self.gates, self.basic_events, self.house_events):
            if name in table:
                raise ValidityError(
                    f"Duplicate event name '{name}' in component '{self.name}'.")

    def add_gate(self, gate: Gate) -> None:
        self._check_event_name(gate.name)
        self.gates.add(gate)

    def add_basic_event(self, event: BasicEvent) -> None:
        self._check_event_name(event.name)
        self.basic_events.add(event)

    def add_house_event(self, event: HouseEvent) -> None:
        self._check_event_name(event.name)
        self.house_events.add(event)

    def add_parameter(self, parameter: Parameter) -> None:
        self.parameters.add(parameter)

    def add_ccf_group(self, group: CcfGroup) -> None:
        # CCF members may not collide with other events in scope.
        for member in group.members:
            self._check_event_name(member.name)
        self.ccf_groups.add(group)

    def add_component(self, component: "Component") -> None:
        self.components.add(component)

    def gather_gates(self) -> set[Gate]:
        """All gates in this component and its sub-components recursively."""
        gates = set(self.gates)
        for sub in self.components:
            gates |= sub.gather_gates()
        return gates


class FaultTree(Component):
    """A top-level fault-tree container with top-event detection.

    ``collect_top_events`` finds gates that are not arguments of any other
    gate in this tree (reference fault_tree.h:151-186): mark all gates
    reachable as args non-top, then collect the unmarked.
    """

    kind = "fault tree"

    def __init__(self, name: str):
        super().__init__(name)
        self.top_events: list[Gate] = []

    def collect_top_events(self) -> None:
        self.top_events.clear()
        gates = self.gather_gates()
        for gate in gates:
            if gate.formula is None:
                continue
            self._mark_non_top(gate, gates)
        self.top_events = [g for g in gates if g.mark is not NodeMark.PERMANENT]
        for gate in gates:
            gate.mark = None

    @staticmethod
    def _mark_non_top(gate: Gate, in_tree: set[Gate]) -> None:
        for arg in gate.formula.args:
            event = arg.event
            if isinstance(event, Gate) and event in in_tree:
                event.mark = NodeMark.PERMANENT
