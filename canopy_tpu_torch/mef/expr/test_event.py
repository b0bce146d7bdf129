"""Event-tree walk test expressions (reference ``expr/test_event.h:16-75``).

These expressions read the *current event-tree walk context* — which
initiating event started the walk and which functional-event states have
been chosen on the current path. The reference keeps a single global
context on the model (``model.h:71-76``, "two event-trees cannot be walked
concurrently"); the rebuild keeps the same Context object but the walker is
reentrant (the context is swapped in/out around each walk).
"""

from __future__ import annotations

from ..expression import Expression, Interval


class TestInitiatingEvent(Expression):
    """1 if the walk was started by the named initiating event."""

    tape_op = "test-initiating-event"

    def __init__(self, name: str, context):
        super().__init__()
        self.event_name = name
        self.context = context

    def value(self) -> float:
        return float(self.context.initiating_event == self.event_name)

    def _compute(self):  # pragma: no cover - value() overridden
        return self.value()

    def is_deviate(self) -> bool:
        return False

    def interval(self) -> Interval:
        return Interval.closed(0.0, 1.0)

    def _do_sample(self, rng) -> float:
        return self.value()


class TestFunctionalEvent(Expression):
    """1 if the named functional event took the given state on this path."""

    tape_op = "test-functional-event"

    def __init__(self, name: str, state: str, context):
        super().__init__()
        self.event_name = name
        self.state = state
        self.context = context

    def value(self) -> float:
        return float(
            self.context.functional_events.get(self.event_name) == self.state)

    def _compute(self):  # pragma: no cover - value() overridden
        return self.value()

    def is_deviate(self) -> bool:
        return False

    def interval(self) -> Interval:
        return Interval.closed(0.0, 1.0)

    def _do_sample(self, rng) -> float:
        return self.value()
