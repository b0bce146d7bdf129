"""MEF model serialization: Model -> Open-PSA XML.

The inverse of the initializer (the reference only reads; round-trip
serialization is what lets tooling emit models, fixtures regenerate
deterministically, and property tests close the loop: parse ➜ serialize
➜ parse must preserve quantification results exactly).

Covers the constructs the initializer accepts: fault trees (gates with
every connective, basic/house events, parameters with units), model-data,
CCF groups, event trees (sequences, functional events, branches, forks,
instructions), initiating events, rules, alignments, and substitutions.
Expressions serialize through a class -> element-name registry mirroring
the reader's extractor table.

The JAX package's writer on the standard library's ``ElementTree`` in
place of lxml (which the GPU machine does not have): the same elements,
attributes and order, UTF-8 bytes with an XML declaration, indented.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from ..mef.alignment import Alignment
from ..mef.ccf_group import (AlphaFactorModel, BetaFactorModel, CcfEvent,
                             CcfGroup, MglModel, PhiFactorModel)
from ..mef.event import (BasicEvent, CONNECTIVE_NAMES, Connective,
                         FALSE_EVENT, Formula, Gate, HouseEvent, TRUE_EVENT)
from ..mef.event_tree import (Branch, EventTree, Fork, NamedBranch,
                              Sequence)
from ..mef.expr import boolean as b
from ..mef.expr import conditional as cond
from ..mef.expr import numerical as num
from ..mef.expr.constant import ConstantExpression, ONE, PI, ZERO
from ..mef.expr.exponential import Exponential, Glm, PeriodicTest, Weibull
from ..mef.expr.extern import ExternExpression
from ..mef.expr.random_deviate import (BetaDeviate, GammaDeviate, Histogram,
                                       LognormalDeviate, NormalDeviate,
                                       UniformDeviate)
from ..mef.expr.test_event import TestFunctionalEvent, TestInitiatingEvent
from ..mef.instruction import (Block, CollectExpression, CollectFormula,
                               IfThenElse, Link, Rule, SetHouseEvent)
from ..mef.model import Model
from ..mef.parameter import MissionTime, Parameter, UNIT_NAMES

__all__ = ["model_to_mef_xml"]

#: Expression class -> MEF element name (inverse of the reader tables).
_SIMPLE_EXPR = {
    num.Neg: "neg", num.Add: "add", num.Sub: "sub", num.Mul: "mul",
    num.Div: "div", num.Abs: "abs", num.Acos: "acos", num.Asin: "asin",
    num.Atan: "atan", num.Cos: "cos", num.Sin: "sin", num.Tan: "tan",
    num.Cosh: "cosh", num.Sinh: "sinh", num.Tanh: "tanh", num.Exp: "exp",
    num.Log: "log", num.Log10: "log10", num.Mod: "mod", num.Pow: "pow",
    num.Sqrt: "sqrt", num.Ceil: "ceil", num.Floor: "floor", num.Min: "min",
    num.Max: "max", num.Mean: "mean",
    b.Not: "not", b.And: "and", b.Or: "or", b.Eq: "eq", b.Df: "df",
    b.Lt: "lt", b.Gt: "gt", b.Leq: "leq", b.Geq: "geq",
    Exponential: "exponential", Glm: "GLM", Weibull: "Weibull",
    PeriodicTest: "periodic-test",
    UniformDeviate: "uniform-deviate", NormalDeviate: "normal-deviate",
    LognormalDeviate: "lognormal-deviate", GammaDeviate: "gamma-deviate",
    BetaDeviate: "beta-deviate",
}

_CCF_MODEL_NAMES = {BetaFactorModel: "beta-factor", MglModel: "MGL",
                    AlphaFactorModel: "alpha-factor",
                    PhiFactorModel: "phi-factor"}


def _emit_expression(parent, expr) -> None:
    if isinstance(expr, MissionTime):
        ET.SubElement(parent, "system-mission-time")
        return
    if isinstance(expr, Parameter):
        ET.SubElement(parent, "parameter", name=expr.id)
        return
    if isinstance(expr, ConstantExpression):
        if expr is PI:
            ET.SubElement(parent, "pi")
            return
        value = expr.value()
        if value == int(value) and abs(value) < 2**53 and \
                expr not in (ONE, ZERO):
            ET.SubElement(parent, "int", value=str(int(value)))
        else:
            ET.SubElement(parent, "float", value=repr(value))
        return
    if isinstance(expr, TestInitiatingEvent):
        ET.SubElement(parent, "test-initiating-event",
                      name=expr.event_name)
        return
    if isinstance(expr, TestFunctionalEvent):
        ET.SubElement(parent, "test-functional-event",
                      name=expr.event_name, state=expr.state)
        return
    if isinstance(expr, ExternExpression):
        el = ET.SubElement(parent, "extern-function",
                           name=expr.function.name)
        for arg in expr.args:
            _emit_expression(el, arg)
        return
    if isinstance(expr, Histogram):
        el = ET.SubElement(parent, "histogram")
        _emit_expression(el, expr.boundaries[0])
        for boundary, weight in zip(expr.boundaries[1:], expr.weights):
            bin_el = ET.SubElement(el, "bin")
            _emit_expression(bin_el, boundary)
            _emit_expression(bin_el, weight)
        return
    if isinstance(expr, cond.Ite):
        el = ET.SubElement(parent, "ite")
        for arg in expr.args:
            _emit_expression(el, arg)
        return
    if isinstance(expr, cond.Switch):
        el = ET.SubElement(parent, "switch")
        for case_cond, case_val in expr.cases:
            case_el = ET.SubElement(el, "case")
            _emit_expression(case_el, case_cond)
            _emit_expression(case_el, case_val)
        _emit_expression(el, expr.default)
        return
    name = _SIMPLE_EXPR.get(type(expr))
    if name is None:
        raise TypeError(f"No MEF serialization for {type(expr).__name__}")
    el = ET.SubElement(parent, name)
    for arg in expr.args:
        _emit_expression(el, arg)


def _emit_arg(parent, arg) -> None:
    event = arg.event
    if event is TRUE_EVENT or event is FALSE_EVENT:
        ET.SubElement(parent, "constant",
                      value="true" if event.state else "false")
        return
    if isinstance(event, Gate):
        kind = "gate"
    elif isinstance(event, HouseEvent):
        kind = "house-event"
    else:
        kind = "basic-event"
    target = parent
    if arg.complement:
        target = ET.SubElement(parent, "not")
    ET.SubElement(target, kind, name=event.id)


def _emit_formula(parent, formula: Formula) -> None:
    c = formula.connective
    if c is Connective.NULL:
        _emit_arg(parent, formula.args[0])
        return
    attrs = {}
    if c is Connective.ATLEAST:
        attrs["min"] = str(formula.min_number)
    elif c is Connective.CARDINALITY:
        attrs["min"] = str(formula.min_number)
        attrs["max"] = str(formula.max_number)
    el = ET.SubElement(parent, CONNECTIVE_NAMES[c], **attrs)
    for arg in formula.args:
        _emit_arg(el, arg)


def _emit_instruction(parent, instruction) -> None:
    if isinstance(instruction, Rule):
        ET.SubElement(parent, "rule", name=instruction.id)
    elif isinstance(instruction, Link):
        ET.SubElement(parent, "event-tree",
                      name=instruction.event_tree.id)
    elif isinstance(instruction, SetHouseEvent):
        el = ET.SubElement(parent, "set-house-event",
                           name=instruction.name)
        ET.SubElement(el, "constant",
                      value="true" if instruction.state else "false")
    elif isinstance(instruction, CollectExpression):
        el = ET.SubElement(parent, "collect-expression")
        _emit_expression(el, instruction.expression)
    elif isinstance(instruction, CollectFormula):
        el = ET.SubElement(parent, "collect-formula")
        _emit_formula(el, instruction.formula)
    elif isinstance(instruction, IfThenElse):
        el = ET.SubElement(parent, "if")
        _emit_expression(el, instruction.expression)
        _emit_instruction(el, instruction.then_instruction)
        if instruction.else_instruction is not None:
            _emit_instruction(el, instruction.else_instruction)
    elif isinstance(instruction, Block):
        el = ET.SubElement(parent, "block")
        for inner in instruction.instructions:
            _emit_instruction(el, inner)
    else:  # pragma: no cover - defensive
        raise TypeError(f"No serialization for {type(instruction)}")


def _emit_branch(parent, branch: Branch) -> None:
    for instruction in branch.instructions:
        _emit_instruction(parent, instruction)
    target = branch.target
    if isinstance(target, Sequence):
        ET.SubElement(parent, "sequence", name=target.id)
    elif isinstance(target, NamedBranch):
        ET.SubElement(parent, "branch", name=target.name)
    elif isinstance(target, Fork):
        fork_el = ET.SubElement(
            parent, "fork",
            **{"functional-event": target.functional_event.name})
        for path in target.paths:
            path_el = ET.SubElement(fork_el, "path", state=path.state)
            _emit_branch(path_el, path)


def model_to_mef_xml(model: Model) -> bytes:
    root = ET.Element("opsa-mef")
    if not model.has_default_name:
        root.set("name", model.name)

    for initiating in model.initiating_events:
        attrs = {"name": initiating.name}
        if initiating.event_tree is not None:
            attrs["event-tree"] = initiating.event_tree.id
        ET.SubElement(root, "define-initiating-event", **attrs)

    for rule in model.rules:
        el = ET.SubElement(root, "define-rule", name=rule.name)
        for instruction in rule.instructions:
            _emit_instruction(el, instruction)

    for event_tree in model.event_trees:
        et_el = ET.SubElement(root, "define-event-tree",
                              name=event_tree.name)
        for functional in event_tree.functional_events:
            ET.SubElement(et_el, "define-functional-event",
                          name=functional.name)
        for sequence in event_tree.sequences:
            seq_el = ET.SubElement(et_el, "define-sequence",
                                   name=sequence.name)
            for instruction in sequence.instructions:
                _emit_instruction(seq_el, instruction)
        for branch in event_tree.branches:
            br_el = ET.SubElement(et_el, "define-branch",
                                  name=branch.name)
            _emit_branch(br_el, branch)
        initial = ET.SubElement(et_el, "initial-state")
        _emit_branch(initial, event_tree.initial_state)

    for fault_tree in model.fault_trees:
        ft_el = ET.SubElement(root, "define-fault-tree",
                              name=fault_tree.name)
        for gate in fault_tree.gates:
            gate_el = ET.SubElement(ft_el, "define-gate", name=gate.name)
            _emit_formula(gate_el, gate.formula)
        for event in fault_tree.basic_events:
            if isinstance(event, CcfEvent):
                continue  # Generated, not source constructs.
            ev_el = ET.SubElement(ft_el, "define-basic-event",
                                  name=event.name)
            if event.has_expression:
                _emit_expression(ev_el, event.expression)
        for house in fault_tree.house_events:
            h_el = ET.SubElement(ft_el, "define-house-event",
                                 name=house.name)
            ET.SubElement(h_el, "constant",
                          value="true" if house.state else "false")
        for parameter in fault_tree.parameters:
            _emit_parameter(ft_el, parameter)
        for group in fault_tree.ccf_groups:
            _emit_ccf_group(ft_el, group)

    # Everything not owned by a fault tree goes to model-data.
    owned_basic = {id(e) for ft in model.fault_trees
                   for e in ft.basic_events}
    owned_house = {id(e) for ft in model.fault_trees
                   for e in ft.house_events}
    owned_param = {id(p) for ft in model.fault_trees
                   for p in ft.parameters}
    owned_ccf_members = {id(e) for g in model.ccf_groups
                         for e in g.members}
    loose_basic = [e for e in model.basic_events
                   if id(e) not in owned_basic and not isinstance(e, CcfEvent)
                   and id(e) not in owned_ccf_members]
    loose_house = [e for e in model.house_events
                   if id(e) not in owned_house]
    loose_param = [p for p in model.parameters if id(p) not in owned_param]
    if loose_basic or loose_house or loose_param:
        md = ET.SubElement(root, "model-data")
        for event in loose_basic:
            ev_el = ET.SubElement(md, "define-basic-event",
                                  name=event.name)
            if event.has_expression:
                _emit_expression(ev_el, event.expression)
        for house in loose_house:
            h_el = ET.SubElement(md, "define-house-event",
                                 name=house.name)
            ET.SubElement(h_el, "constant",
                          value="true" if house.state else "false")
        for parameter in loose_param:
            _emit_parameter(md, parameter)

    for alignment in model.alignments:
        al_el = ET.SubElement(root, "define-alignment",
                              name=alignment.name)
        for phase in alignment.phases:
            ph_el = ET.SubElement(
                al_el, "define-phase", name=phase.name,
                **{"time-fraction": repr(phase.time_fraction)})
            for instruction in phase.instructions:
                _emit_instruction(ph_el, instruction)

    for substitution in model.substitutions:
        sub_el = ET.SubElement(root, "define-substitution",
                               name=substitution.name)
        hyp = ET.SubElement(sub_el, "hypothesis")
        _emit_formula(hyp, substitution.hypothesis)
        if substitution.source:
            source = ET.SubElement(sub_el, "source")
            for event in substitution.source:
                ET.SubElement(source, "basic-event", name=event.id)
        target = ET.SubElement(sub_el, "target")
        if isinstance(substitution.target, BasicEvent):
            ET.SubElement(target, "basic-event",
                          name=substitution.target.id)
        else:
            ET.SubElement(
                target, "constant",
                value="true" if substitution.target else "false")

    ET.indent(root)
    return ET.tostring(root, encoding="UTF-8", xml_declaration=True) + b"\n"


def _emit_parameter(parent, parameter: Parameter) -> None:
    attrs = {"name": parameter.name}
    if parameter.unit:
        attrs["unit"] = UNIT_NAMES[parameter.unit]
    el = ET.SubElement(parent, "define-parameter", **attrs)
    _emit_expression(el, parameter.expression)


def _emit_ccf_group(parent, group: CcfGroup) -> None:
    el = ET.SubElement(parent, "define-CCF-group", name=group.name,
                       model=_CCF_MODEL_NAMES[type(group)])
    members = ET.SubElement(el, "members")
    for member in group.members:
        ET.SubElement(members, "basic-event", name=member.name)
    dist = ET.SubElement(el, "distribution")
    _emit_expression(dist, group.distribution)
    for level, factor in group.factors:
        f_el = ET.SubElement(el, "factor", level=str(level))
        _emit_expression(f_el, factor)
