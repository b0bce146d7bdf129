"""Event-tree instructions (reference ``instruction.h:21-215``).

A visitor-based AST of model modifiers executed during event-tree walks:
``SetHouseEvent`` flips a house event, ``CollectExpression`` multiplies the
sequence probability, ``CollectFormula`` conjoins a fault-tree formula into
the path, ``IfThenElse``/``Block`` compound, ``Rule`` names a reusable
instruction list, and ``Link`` jumps to another event tree (end-state only).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from .element import Element

if TYPE_CHECKING:  # pragma: no cover
    from .event import Formula
    from .event_tree import EventTree
    from .expression import Expression


class Instruction:
    """Base of the instruction AST."""

    def accept(self, visitor: "InstructionVisitor"):
        raise NotImplementedError


class InstructionVisitor:
    """Double-dispatch visitor (reference instruction.h:170-196)."""

    def visit_set_house_event(self, instruction: "SetHouseEvent"):
        raise NotImplementedError

    def visit_collect_expression(self, instruction: "CollectExpression"):
        raise NotImplementedError

    def visit_collect_formula(self, instruction: "CollectFormula"):
        raise NotImplementedError

    def visit_link(self, instruction: "Link"):
        raise NotImplementedError

    def visit_if_then_else(self, instruction: "IfThenElse"):
        instruction.then_instruction.accept(self)
        if instruction.else_instruction is not None:
            instruction.else_instruction.accept(self)

    def visit_block(self, instruction: "Block"):
        for inner in instruction.instructions:
            inner.accept(self)

    def visit_rule(self, rule: "Rule"):
        for inner in rule.instructions:
            inner.accept(self)


class NullVisitor(InstructionVisitor):
    """A visitor that ignores everything (reference instruction.h:199-215)."""

    def visit_set_house_event(self, instruction):
        pass

    def visit_collect_expression(self, instruction):
        pass

    def visit_collect_formula(self, instruction):
        pass

    def visit_link(self, instruction):
        pass


class SetHouseEvent(Instruction):
    """Set a house event's state for the rest of the walk."""

    def __init__(self, name: str, state: bool):
        self.name = name
        self.state = state

    def accept(self, visitor):
        return visitor.visit_set_house_event(self)


class CollectExpression(Instruction):
    """Multiply the sequence probability by an expression."""

    def __init__(self, expression: "Expression"):
        self.expression = expression

    def accept(self, visitor):
        return visitor.visit_collect_expression(self)


class CollectFormula(Instruction):
    """Conjoin a formula into the path condition."""

    def __init__(self, formula: "Formula"):
        self.formula = formula

    def accept(self, visitor):
        return visitor.visit_collect_formula(self)


class IfThenElse(Instruction):
    def __init__(self, expression: "Expression", then_instruction: Instruction,
                 else_instruction: Optional[Instruction] = None):
        self.expression = expression
        self.then_instruction = then_instruction
        self.else_instruction = else_instruction

    def accept(self, visitor):
        return visitor.visit_if_then_else(self)


class Block(Instruction):
    def __init__(self, instructions: list[Instruction]):
        self.instructions = instructions

    def accept(self, visitor):
        return visitor.visit_block(self)


class Rule(Element, Instruction):
    """A named, reusable instruction list."""

    kind = "rule"

    def __init__(self, name: str):
        Element.__init__(self, name)
        self.instructions: list[Instruction] = []

    def accept(self, visitor):
        return visitor.visit_rule(self)


class Link(Instruction):
    """Jump to another event tree; allowed only in end-state sequences."""

    def __init__(self, event_tree: "EventTree"):
        self.event_tree = event_tree
        self.mark = None  # For link-cycle detection DFS.
        self.id = f"link->{event_tree.name}"

    def accept(self, visitor):
        return visitor.visit_link(self)
