"""Generic cycle detection over heterogeneous model graphs.

Capability parity with the reference cycle machinery
(``reference/src/mef/openpsa/cycle.h:115-324``): a three-color DFS
that works over gates (through formula arguments), parameters (through
expression arguments), event-tree named branches (through fork paths),
rules (through instruction visitors), and event-tree links. On detection it
raises :class:`CycleError` with the pretty-printed cycle path.

The same DFS doubles as the topological order used by the compiler's level
scheduler — the no-cycle guarantee is what lets the TPU engine propagate
probabilities level-by-level with static shapes.
"""

from __future__ import annotations

from typing import Callable, Iterable, TypeVar

from ..errors import CycleError
from .element import NodeMark
from .event import Gate
from .event_tree import Branch, Fork, NamedBranch, Sequence
from .instruction import InstructionVisitor, Link, Rule
from .parameter import Parameter

T = TypeVar("T")


def detect_cycle(node: T, successors: Callable[[T], Iterable[T]],
                 trail: list[T]) -> bool:
    """Three-color DFS; fills ``trail`` with the cycle path on detection."""
    if node.mark is None or node.mark is NodeMark.CLEAR:
        node.mark = NodeMark.TEMPORARY
        for nxt in successors(node):
            if detect_cycle(nxt, successors, trail):
                trail.append(node)
                return True
        node.mark = NodeMark.PERMANENT
        return False
    if node.mark is NodeMark.TEMPORARY:
        trail.append(node)
        return True
    assert node.mark is NodeMark.PERMANENT
    return False


def print_cycle(trail: list) -> str:
    """Human-readable cycle: 'a->b->...->a' (reference cycle.h PrintCycle)."""
    names = [getattr(node, "id", getattr(node, "name", str(node)))
             for node in reversed(trail)]
    return "->".join(names)


def check_cycle(nodes: Iterable[T], successors: Callable[[T], Iterable[T]],
                kind: str) -> None:
    """Check every node; raise CycleError naming the cycle (cycle.h:219-229)."""
    nodes = list(nodes)
    for node in nodes:
        node.mark = None
    try:
        for node in nodes:
            trail: list = []
            if detect_cycle(node, successors, trail):
                raise CycleError(
                    f"Detected a cycle in '{kind}' elements: "
                    f"{print_cycle(trail)}")
    finally:
        for node in nodes:
            node.mark = None


# -- successor functions for each graph kind --------------------------------

def gate_successors(gate: Gate) -> Iterable[Gate]:
    if gate.formula is None:
        return
    for arg in gate.formula.args:
        if isinstance(arg.event, Gate):
            yield arg.event


def parameter_successors(parameter: Parameter):
    """Parameters reachable through the expression DAG (cycle.h:231-284)."""
    stack = list(parameter.args)
    seen: set[int] = set()
    while stack:
        expr = stack.pop()
        if id(expr) in seen:
            continue
        seen.add(id(expr))
        if isinstance(expr, Parameter):
            yield expr
        else:
            stack.extend(expr.args)


def branch_successors(branch: Branch) -> Iterable[NamedBranch]:
    """Named branches reachable from a branch's target (cycle.h:286-322)."""
    target = branch.target
    if isinstance(target, NamedBranch):
        yield target
    elif isinstance(target, Fork):
        for path in target.paths:
            yield from branch_successors(path)


class _RuleCollector(InstructionVisitor):
    """Finds Rule references inside instruction trees."""

    def __init__(self):
        self.rules: list[Rule] = []
        self.links: list[Link] = []

    def visit_set_house_event(self, instruction):
        pass

    def visit_collect_expression(self, instruction):
        pass

    def visit_collect_formula(self, instruction):
        pass

    def visit_link(self, instruction):
        self.links.append(instruction)

    def visit_rule(self, rule):
        self.rules.append(rule)
        # Do not descend: the cycle check recurses per-rule.


def rule_successors(rule: Rule) -> Iterable[Rule]:
    collector = _RuleCollector()
    for instruction in rule.instructions:
        instruction.accept(collector)
    return collector.rules


def link_successors(link: Link) -> Iterable[Link]:
    """Links reachable through the target event tree (cycle.h link spec)."""
    collector = _RuleCollector()
    tree = link.event_tree

    def walk_branch(branch: Branch):
        for instruction in branch.instructions:
            instruction.accept(collector)
        target = branch.target
        if isinstance(target, Fork):
            for path in target.paths:
                walk_branch(path)
        elif isinstance(target, Sequence):
            for instruction in target.instructions:
                instruction.accept(collector)
        elif isinstance(target, NamedBranch):
            pass  # Covered by the per-tree named-branch iteration below.

    walk_branch(tree.initial_state)
    for branch in tree.branches:
        walk_branch(branch)
    # Expand rules transitively: links may hide inside rules.
    seen_rules = set()
    frontier = list(collector.rules)
    while frontier:
        rule = frontier.pop()
        if id(rule) in seen_rules:
            continue
        seen_rules.add(id(rule))
        inner = _RuleCollector()
        for instruction in rule.instructions:
            instruction.accept(inner)
        collector.links.extend(inner.links)
        frontier.extend(inner.rules)
    return collector.links
