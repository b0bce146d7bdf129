"""Open-PSA MEF models read with the standard library alone.

The reference's own reader: fault trees (gates over ``and``, ``or``,
``atleast`` and ``not`` of gates and basic events), basic events whose
probability is a constant or a lognormal deviate given by its mean, error
factor and level.  Anything else raises, so a model the reference cannot
read is never judged by a reference that guessed.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

__all__ = ["Model", "Lognormal", "read_model", "reached_basic_events",
           "top_events"]


@dataclasses.dataclass(frozen=True)
class Lognormal:
    """A lognormal deviate by its mean, error factor and level."""
    mean: float
    error_factor: float
    level: float


@dataclasses.dataclass
class Model:
    #: gate name -> formula: ("and" | "or", [args]), ("atleast", k, [args]),
    #: ("not", arg), ("gate", name), ("basic", name).
    gates: dict
    #: gate name -> the fault tree that defines it.
    gate_tree: dict
    #: fault tree names in the order the files define them.
    fault_trees: list
    #: basic event name -> float or Lognormal.
    basic: dict


class UnsupportedModel(ValueError):
    """A construct the reference does not read."""


def _formula(node):
    tag = node.tag
    if tag == "gate":
        return ("gate", node.get("name"))
    if tag == "basic-event":
        return ("basic", node.get("name"))
    if tag in ("and", "or"):
        return (tag, [_formula(c) for c in node])
    if tag == "atleast":
        return ("atleast", int(node.get("min")), [_formula(c) for c in node])
    if tag == "not":
        (child,) = list(node)
        return ("not", _formula(child))
    raise UnsupportedModel(f"formula element <{tag}>")


def _number(node) -> float:
    if node.tag not in ("float", "int"):
        raise UnsupportedModel(f"expression element <{node.tag}>")
    return float(node.get("value"))


def _expression(node):
    if node.tag in ("float", "int"):
        return _number(node)
    if node.tag == "lognormal-deviate":
        args = [_number(c) for c in node]
        if len(args) != 3:
            raise UnsupportedModel("lognormal deviate by mean, error "
                                   "factor and level only")
        return Lognormal(*args)
    raise UnsupportedModel(f"expression element <{node.tag}>")


def read_model(paths) -> Model:
    model = Model({}, {}, [], {})

    def define_gate(node, tree):
        (formula,) = list(node)
        model.gates[node.get("name")] = _formula(formula)
        model.gate_tree[node.get("name")] = tree

    def define_basic(node):
        (expr,) = list(node)
        model.basic[node.get("name")] = _expression(expr)

    for path in paths:
        root = ET.parse(path).getroot()
        for node in root:
            if node.tag == "define-fault-tree":
                tree = node.get("name")
                model.fault_trees.append(tree)
                for child in node:
                    if child.tag == "define-gate":
                        define_gate(child, tree)
                    elif child.tag == "define-basic-event":
                        define_basic(child)
                    else:
                        raise UnsupportedModel(f"<{child.tag}> in a tree")
            elif node.tag == "model-data":
                for child in node:
                    if child.tag != "define-basic-event":
                        raise UnsupportedModel(f"<{child.tag}> in data")
                    define_basic(child)
            else:
                raise UnsupportedModel(f"<{node.tag}> at the top level")
    return model


def _children(formula):
    kind = formula[0]
    if kind in ("and", "or"):
        return formula[1]
    if kind == "atleast":
        return formula[2]
    if kind == "not":
        return [formula[1]]
    return []


def reached_basic_events(model: Model, formula) -> list[str]:
    """The basic events a formula reaches, sorted by name: the order in
    which the analysis numbers them, and so the order of their samples."""
    seen_gates, basics = set(), set()
    stack = [formula]
    while stack:
        f = stack.pop()
        if f[0] == "gate":
            if f[1] not in seen_gates:
                seen_gates.add(f[1])
                stack.append(model.gates[f[1]])
        elif f[0] == "basic":
            basics.add(f[1])
        else:
            stack.extend(_children(f))
    return sorted(basics)


def top_events(model: Model) -> list[tuple[str, str]]:
    """(fault tree, top gate) pairs: per fault tree, its gates that no
    gate of the same tree names."""
    named = {}
    for gate, formula in model.gates.items():
        stack = [formula]
        while stack:
            f = stack.pop()
            if f[0] == "gate":
                named.setdefault(model.gate_tree[gate], set()).add(f[1])
            else:
                stack.extend(_children(f))
    out = []
    for tree in model.fault_trees:
        for gate, owner in model.gate_tree.items():
            if owner == tree and gate not in named.get(tree, set()):
                out.append((tree, gate))
    return out
