"""Event trees (reference ``event_tree.h:18-224``).

Sequences, ordered functional events, branches (instructions + target),
named branches, state-labelled paths, forks, the event-tree composite, and
initiating events. The quantification side compiles the walk into chained
sparse compositions (:mod:`canopy_tpu.engine.event_tree_walk`).
"""

from __future__ import annotations

from typing import Optional, Union

from ..errors import DuplicateElementError, ValidityError
from .element import Element, RoleSpecifier, Table
from .instruction import Instruction


class Sequence(Element):
    """An end-state of an event tree with its instructions."""

    kind = "sequence"

    def __init__(self, name: str):
        super().__init__(name)
        self.instructions: list[Instruction] = []


class FunctionalEvent(Element):
    """A pivotal (functional) event; ordered by definition position."""

    kind = "functional event"

    def __init__(self, name: str):
        super().__init__(name)
        self.order = 0


#: A branch target: a sequence, a fork, or a named branch.
Target = Union[Sequence, "Fork", "NamedBranch"]


class Branch:
    """Instructions followed by a target (reference event_tree.h:65-94)."""

    def __init__(self):
        self.instructions: list[Instruction] = []
        self.target: Optional[Target] = None


class NamedBranch(Branch, Element):
    """A reusable named branch within one event tree."""

    kind = "branch"

    def __init__(self, name: str):
        Branch.__init__(self)
        Element.__init__(self, name)


class Path(Branch):
    """A state-labelled branch inside a fork."""

    def __init__(self, state: str):
        super().__init__()
        if not state:
            raise ValidityError("The fork path state cannot be empty.")
        self.state = state


class Fork:
    """A functional event with one path per state (event_tree.h:126-158)."""

    def __init__(self, functional_event: FunctionalEvent, paths: list[Path]):
        seen: set[str] = set()
        for path in paths:
            if path.state in seen:
                raise DuplicateElementError(
                    f"path state '{path.state}' in fork over "
                    f"'{functional_event.name}'")
            seen.add(path.state)
        self.functional_event = functional_event
        self.paths = paths


class EventTree(Element):
    """Composite of sequences, functional events, branches, and forks."""

    kind = "event tree"

    def __init__(self, name: str):
        super().__init__(name)
        self.sequences: Table[Sequence] = Table("sequence", by_id=False)
        self.functional_events: Table[FunctionalEvent] = Table(
            "functional event", by_id=False)
        self.branches: Table[NamedBranch] = Table("branch", by_id=False)
        self.forks: list[Fork] = []
        self.initial_state: Branch = Branch()


class InitiatingEvent(Element):
    """The event that starts an event-tree walk."""

    kind = "initiating event"

    def __init__(self, name: str):
        super().__init__(name)
        self.event_tree: Optional[EventTree] = None
        #: Optional frequency/probability expression (MEF extension).
        self.expression = None
