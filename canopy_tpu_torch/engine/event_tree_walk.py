"""Event-tree walk compiler: sequences -> quantifiable path conditions.

Implements the walk protocol implied by the reference types (SURVEY.md
§3.4): starting from an initiating event, branches execute instructions
(``SetHouseEvent`` flips, ``CollectExpression`` multiplies,
``CollectFormula`` conjoins, if/block/rule compounds, ``Link`` jumps to a
linked tree's initial state), forks split on functional-event states, and
sequences terminate paths.

The walker is *reentrant* (the model's global walk context is swapped
around each walk — lifting the reference's "two event-trees cannot be
walked concurrently" restriction, ``model.h:71-76``) and produces one
:class:`SequenceOutcome` per reached end state:

* collected expressions multiply into a per-path expression list
  (quantified through the expression tape), and
* collected formulas conjoin into a single AND formula per path, which
  compiles through the standard gate compiler — the event-tree "linking"
  is gate composition over the shared basic-event space, i.e. the SpGEMM
  structure of BASELINE.json config 4 realized as one fused gate graph.

House-event flips are *path-local*: each outcome records the house-state
vector in force when its sequence was reached, so one compiled tree
quantifies every sequence by swapping house inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..errors import LogicError
from ..mef.event import Arg, Connective, Formula, Gate
from ..mef.event_tree import (Branch, EventTree, Fork, InitiatingEvent,
                              NamedBranch, Path, Sequence)
from ..mef.expression import Expression
from ..mef.instruction import (Block, CollectExpression, CollectFormula,
                               IfThenElse, Instruction, Link, Rule,
                               SetHouseEvent)
from ..mef.model import Model

__all__ = ["SequenceOutcome", "walk_event_tree"]


@dataclasses.dataclass
class SequenceOutcome:
    """One end-state of the walk."""

    sequence: Sequence
    #: Functional-event states chosen along this path.
    states: dict[str, str]
    #: Expressions collected (their product is the path probability).
    expressions: list[Expression]
    #: Formulas collected (their conjunction is the path condition).
    formulas: list[Formula]
    #: House-event states in force at the end of the path (id -> state).
    house_states: dict[str, bool]
    #: Trees linked through (for reporting).
    linked_trees: list[str]

    def conjoined_gate(self, name: str) -> Optional[Gate]:
        """The path condition as a single gate (None without formulas)."""
        if not self.formulas:
            return None
        gate = Gate(name)
        if len(self.formulas) == 1:
            gate.formula = self.formulas[0]
        else:
            # Conjoin via single-arg indirection gates so each collected
            # formula keeps its own connective.
            args = []
            for i, formula in enumerate(self.formulas):
                sub = Gate(f"{name}__f{i}")
                sub.formula = formula
                args.append(Arg(sub))
            gate.formula = Formula(Connective.AND, args)
        return gate


class _Walker:
    def __init__(self, model: Model, tree: EventTree,
                 initiating_event: InitiatingEvent):
        self.model = model
        self.tree = tree
        self.initiating_event = initiating_event
        self.outcomes: list[SequenceOutcome] = []

    def walk(self) -> list[SequenceOutcome]:
        context = self.model.context
        saved = (context.initiating_event, dict(context.functional_events))
        context.initiating_event = self.initiating_event.name
        context.functional_events = {}
        house0 = {h.id: h.state for h in self.model.house_events}
        try:
            self._walk_branch(self.tree.initial_state, {}, [], [], house0, [])
        finally:
            context.initiating_event, context.functional_events = saved
        return self.outcomes

    def _walk_branch(self, branch: Branch, states, exprs, formulas, houses,
                     linked):
        exprs = list(exprs)
        formulas = list(formulas)
        houses = dict(houses)
        self._run_instructions(branch.instructions, exprs, formulas, houses,
                               linked)
        target = branch.target
        if isinstance(target, Sequence):
            self._finish_sequence(target, states, exprs, formulas, houses,
                                  linked)
        elif isinstance(target, NamedBranch):
            self._walk_branch(target, states, exprs, formulas, houses, linked)
        elif isinstance(target, Fork):
            for path in target.paths:
                new_states = dict(states)
                new_states[target.functional_event.name] = path.state
                # The walk context drives test-functional-event exprs.
                self.model.context.functional_events = new_states
                self._walk_branch(path, new_states, exprs, formulas, houses,
                                  linked)
        else:
            raise LogicError("Branch without a target in event-tree walk.")

    def _finish_sequence(self, sequence: Sequence, states, exprs, formulas,
                         houses, linked):
        exprs = list(exprs)
        formulas = list(formulas)
        houses = dict(houses)
        link_target: list[EventTree] = []
        self._run_instructions(sequence.instructions, exprs, formulas, houses,
                               linked, link_target)
        if link_target:
            # Link: continue the walk in the target tree's initial state.
            for target_tree in link_target:
                sub = _Walker(self.model, target_tree, self.initiating_event)
                sub.outcomes = self.outcomes
                saved = dict(self.model.context.functional_events)
                sub._walk_branch(target_tree.initial_state, states, exprs,
                                 formulas, houses,
                                 linked + [target_tree.name])
                self.model.context.functional_events = saved
            return
        self.outcomes.append(SequenceOutcome(
            sequence=sequence, states=dict(states), expressions=exprs,
            formulas=formulas, house_states=houses, linked_trees=list(linked)))

    def _run_instructions(self, instructions, exprs, formulas, houses,
                          linked, link_target=None):
        for instruction in instructions:
            self._run(instruction, exprs, formulas, houses, linked,
                      link_target)

    def _run(self, instruction: Instruction, exprs, formulas, houses, linked,
             link_target):
        if isinstance(instruction, SetHouseEvent):
            houses[instruction.name] = instruction.state
            # Also flip the model object so collected expressions that
            # read house states see the path-local value.
            self.model.house_events.get(instruction.name).state = \
                instruction.state
        elif isinstance(instruction, CollectExpression):
            exprs.append(instruction.expression)
        elif isinstance(instruction, CollectFormula):
            formulas.append(instruction.formula)
        elif isinstance(instruction, IfThenElse):
            if instruction.expression.value() != 0:
                self._run(instruction.then_instruction, exprs, formulas,
                          houses, linked, link_target)
            elif instruction.else_instruction is not None:
                self._run(instruction.else_instruction, exprs, formulas,
                          houses, linked, link_target)
        elif isinstance(instruction, Block):
            self._run_instructions(instruction.instructions, exprs, formulas,
                                   houses, linked, link_target)
        elif isinstance(instruction, Rule):
            self._run_instructions(instruction.instructions, exprs, formulas,
                                   houses, linked, link_target)
        elif isinstance(instruction, Link):
            if link_target is None:
                raise LogicError(
                    "Link instructions may only appear in sequences.")
            link_target.append(instruction.event_tree)
        else:  # pragma: no cover - defensive
            raise LogicError(f"Unknown instruction {instruction!r}.")


def walk_event_tree(model: Model,
                    initiating_event: InitiatingEvent) -> list[SequenceOutcome]:
    """All sequence outcomes reachable from an initiating event."""
    if initiating_event.event_tree is None:
        raise LogicError(
            f"Initiating event '{initiating_event.name}' has no event tree.")
    # Snapshot house states; SetHouseEvent flips are walk-local.
    saved_states = {h.id: h.state for h in model.house_events}
    try:
        return _Walker(model, initiating_event.event_tree,
                       initiating_event).walk()
    finally:
        for event_id, state in saved_states.items():
            model.house_events.get(event_id).state = state
