"""The two-phase XML -> Model initializer.

Capability parity with the reference initializer
(``reference/src/mef/openpsa/initializer.{h,cpp}``, ~2.4k LoC), in the
same pipeline order (SURVEY.md §3.1):

1. File handling with glob wildcard expansion, existence and
   canonical-path duplicate checks (``initializer.cpp:153-250``).
2. Parse + optional RELAX NG validation per file (``:252-270``).
3. First pass — **registration** of every named construct, with a
   to-be-defined (TBD) worklist for forward references (``:312-473``).
4. Second pass — **definition** via per-type define methods (``:477-653``),
   including the 47-entry expression extractor table (``:1168-1215``) and
   scoped reference resolution through path tables (``:1354-1439``).
5. Whole-model **validation**: gate/rule/branch/link/parameter cycle
   checks, functional-event order, link placement, event-tree homogeneity,
   substitution conflicts, expression domains (``:1606-1885``).
6. **Setup for analysis**: top-event collection and CCF expansion
   (``:1887-1903``), plus the CCF-substitution and
   substitution-approximation post-checks (``:1818-1858``).
"""

from __future__ import annotations

import glob as _glob
import os

from ..errors import (DuplicateElementError, IllegalOperation, IOError_,
                      UndefinedElement, ValidityError)
from ..io.xml import Document, Element as XmlElement, Validator
from ..settings import Approximation, Settings
from . import cycle
from .alignment import Alignment, Phase
from .ccf_group import (AlphaFactorModel, BetaFactorModel, CcfGroup, MglModel,
                        PhiFactorModel)
from .element import Attribute, Element, RoleSpecifier
from .event import (Arg, BasicEvent, Connective, CONNECTIVE_BY_NAME,
                    FALSE_EVENT, Formula, Gate, HouseEvent, TRUE_EVENT)
from .event_tree import (Branch, EventTree, Fork, FunctionalEvent,
                         InitiatingEvent, NamedBranch, Path, Sequence)
from .expr.boolean import And, Df, Eq, Geq, Gt, Leq, Lt, Not, Or
from .expr.conditional import Ite, Switch
from .expr.constant import ConstantExpression, ONE, PI, ZERO
from .expr.exponential import Exponential, Glm, PeriodicTest, Weibull
from .expr.extern import ExternFunction, ExternLibrary
from .expr.numerical import (Abs, Acos, Add, Asin, Atan, Ceil, Cos, Cosh, Div,
                             Exp, Floor, Log, Log10, Max, Mean, Min, Mod, Mul,
                             Neg, Pow, Sin, Sinh, Sqrt, Sub, Tan, Tanh)
from .expr.random_deviate import (BetaDeviate, GammaDeviate, Histogram,
                                  LognormalDeviate, NormalDeviate,
                                  UniformDeviate)
from .expr.test_event import TestFunctionalEvent, TestInitiatingEvent
from .fault_tree import Component, FaultTree
from .instruction import (Block, CollectExpression, CollectFormula,
                          IfThenElse, Link, Rule, SetHouseEvent)
from .model import Model
from .parameter import Parameter, UNIT_BY_NAME, UNIT_NAMES
from .substitution import SUBSTITUTION_TYPES, Substitution


def _attach_label_and_attributes(xml: XmlElement, element: Element) -> None:
    label = xml.child("label")
    if label is not None:
        element.label = label.text()
    attributes = xml.child("attributes")
    if attributes is not None:
        for attr in attributes.children():
            try:
                element.set_attribute(Attribute(
                    attr.attribute("name") or "",
                    attr.attribute("value") or "",
                    attr.attribute("type") or ""))
            except ValidityError as err:
                raise err.with_context(filename=attr.filename, line=attr.line)


def _get_role(xml: XmlElement, default: RoleSpecifier) -> RoleSpecifier:
    raw = xml.attribute("role")
    if raw is None:
        return default
    return RoleSpecifier(raw)


def _non_attribute_children(xml: XmlElement):
    """Child elements that are not label/attributes metadata."""
    return [child for child in xml.children()
            if child.name not in ("label", "attributes")]


class Initializer:
    """Builds a validated :class:`Model` from MEF XML input files."""

    def __init__(self, xml_files: list[str], settings: Settings,
                 allow_extern: bool = False,
                 schema_path: str | None = None):
        self.settings = settings
        self.allow_extern = allow_extern
        self.model: Model | None = None
        self._validator = Validator(schema_path) if schema_path else None
        self._documents: list[Document] = []
        self._tbd: list[tuple[object, XmlElement]] = []
        self._links: list[Link] = []
        self._expressions: list[tuple[object, XmlElement]] = []
        # Full-path tables for scoped reference resolution
        # (reference initializer.h path_gates_ etc.).
        self._path_gates: dict[str, Gate] = {}
        self._path_basic_events: dict[str, BasicEvent] = {}
        self._path_house_events: dict[str, HouseEvent] = {}
        self._path_parameters: dict[str, Parameter] = {}
        self._process_input_files(xml_files)

    # ==================================================================
    # File handling (initializer.cpp:153-297).
    # ==================================================================

    @staticmethod
    def _expand_wildcards(xml_files: list[str]) -> list[str]:
        expanded: list[str] = []
        for pattern in xml_files:
            if any(ch in pattern for ch in "*?["):
                matches = sorted(_glob.glob(pattern))
                expanded.extend(matches if matches else [pattern])
            else:
                expanded.append(pattern)
        return expanded

    @staticmethod
    def _check_files(xml_files: list[str]) -> None:
        missing = [f for f in xml_files if not os.path.isfile(f)]
        if missing:
            raise IOError_("Input file(s) do not exist or are not regular "
                           f"files: {', '.join(missing)}")
        seen: dict[str, str] = {}
        for path in xml_files:
            canonical = os.path.realpath(path)
            if canonical in seen:
                raise IOError_(f"Duplicate input file: {path} "
                               f"(same as {seen[canonical]})")
            seen[canonical] = path

    def _process_input_files(self, xml_files: list[str]) -> None:
        files = self._expand_wildcards(xml_files)
        self._check_files(files)
        for path in files:
            document = Document(path, self._validator)
            self._documents.append(document)
        for document in self._documents:
            self._process_input_file(document)
        self._process_tbd_elements()
        self._validate_initialization()
        self._setup_for_analysis()
        self._ensure_no_ccf_substitutions()
        self._ensure_substitutions_with_approximations()

    @classmethod
    def from_documents(cls, documents: list[Document], settings: Settings,
                       allow_extern: bool = False) -> "Initializer":
        """Build from pre-parsed documents (in-memory tests, tooling)."""
        self = cls.__new__(cls)
        self.settings = settings
        self.allow_extern = allow_extern
        self.model = None
        self._validator = None
        self._documents = list(documents)
        self._tbd = []
        self._links = []
        self._expressions = []
        self._path_gates = {}
        self._path_basic_events = {}
        self._path_house_events = {}
        self._path_parameters = {}
        for document in self._documents:
            self._process_input_file(document)
        self._process_tbd_elements()
        self._validate_initialization()
        self._setup_for_analysis()
        self._ensure_no_ccf_substitutions()
        self._ensure_substitutions_with_approximations()
        return self

    # ==================================================================
    # Pass 1: registration (initializer.cpp:312-473).
    # ==================================================================

    def _process_input_file(self, document: Document) -> None:
        root = document.root
        if root.name != "opsa-mef":
            raise ValidityError(
                f"Invalid root element '{root.name}' (expected 'opsa-mef').",
                filename=root.filename, line=root.line)
        if self.model is None:
            self.model = Model(root.attribute("name") or "")
            _attach_label_and_attributes(root, self.model)
            self.model.mission_time.set_value(self.settings.mission_time())

        for node in root.children():
            name = node.name
            if name == "define-initiating-event":
                element = self._construct(InitiatingEvent, node)
                self._register(self.model.initiating_events, element, node)
                self._tbd.append((element, node))
            elif name == "define-rule":
                element = self._construct(Rule, node)
                self._register(self.model.rules, element, node)
                self._tbd.append((element, node))
            elif name == "define-event-tree":
                self._define_event_tree(node)
            elif name == "define-fault-tree":
                self._define_fault_tree(node)
            elif name == "define-CCF-group":
                self._register_ccf_group(node, "", RoleSpecifier.PUBLIC)
            elif name == "define-alignment":
                element = self._construct(Alignment, node)
                self._register(self.model.alignments, element, node)
                self._tbd.append((element, node))
            elif name == "define-substitution":
                element = self._construct(Substitution, node)
                self._register(self.model.substitutions, element, node)
                self._tbd.append((element, node))
            elif name == "model-data":
                self._process_model_data(node)
            elif name == "define-extern-library":
                if not self.allow_extern:
                    raise IllegalOperation(
                        "Loading external libraries is disallowed.",
                        filename=node.filename, line=node.line)
                self._define_extern_library(node)

    @staticmethod
    def _construct(cls, xml: XmlElement, *role_args):
        name = xml.attribute("name")
        if name is None:
            raise ValidityError(f"Missing 'name' for '{xml.name}'.",
                                filename=xml.filename, line=xml.line)
        try:
            element = cls(name, *role_args)
        except ValidityError as err:
            raise err.with_context(filename=xml.filename, line=xml.line)
        _attach_label_and_attributes(xml, element)
        element.source_location = (xml.filename, xml.line)
        return element

    def _construct_role(self, cls, xml: XmlElement, base_path: str,
                        container_role: RoleSpecifier):
        role = _get_role(xml, container_role)
        return self._construct(cls, xml, base_path, role)

    @staticmethod
    def _register(table, element, xml: XmlElement):
        try:
            return table.add(element)
        except DuplicateElementError as err:
            raise err.with_context(filename=xml.filename, line=xml.line)

    # -- fault trees -------------------------------------------------------

    def _define_fault_tree(self, node: XmlElement) -> None:
        fault_tree = self._construct(FaultTree, node)
        self._register_fault_tree_data(node, fault_tree.name, fault_tree)
        self._register(self.model.fault_trees, fault_tree, node)

    def _define_component(self, node: XmlElement, base_path: str,
                          container_role: RoleSpecifier) -> Component:
        component = self._construct_role(Component, node, base_path,
                                         container_role)
        self._register_fault_tree_data(
            node, f"{base_path}.{component.name}", component)
        return component

    def _register_fault_tree_data(self, node: XmlElement, base_path: str,
                                  component: Component) -> None:
        for child in node.children():
            name = child.name
            try:
                if name == "define-basic-event":
                    component.add_basic_event(
                        self._register_basic_event(child, base_path,
                                                   component.role))
                elif name == "define-parameter":
                    component.add_parameter(
                        self._register_parameter(child, base_path,
                                                 component.role))
                elif name == "define-gate":
                    component.add_gate(
                        self._register_gate(child, base_path, component.role))
                elif name == "define-house-event":
                    component.add_house_event(
                        self._register_house_event(child, base_path,
                                                   component.role))
                elif name == "define-CCF-group":
                    component.add_ccf_group(
                        self._register_ccf_group(child, base_path,
                                                 component.role))
                elif name == "define-component":
                    component.add_component(
                        self._define_component(child, base_path,
                                               component.role))
            except ValidityError as err:
                raise err.with_context(filename=child.filename,
                                       line=child.line)

    def _process_model_data(self, node: XmlElement) -> None:
        for child in node.children():
            name = child.name
            if name == "define-basic-event":
                self._register_basic_event(child, "", RoleSpecifier.PUBLIC)
            elif name == "define-parameter":
                self._register_parameter(child, "", RoleSpecifier.PUBLIC)
            elif name == "define-house-event":
                self._register_house_event(child, "", RoleSpecifier.PUBLIC)

    # -- per-type registration (initializer.cpp:312-413) -------------------

    def _register_gate(self, node: XmlElement, base_path: str,
                       role: RoleSpecifier) -> Gate:
        gate = self._construct_role(Gate, node, base_path, role)
        self._register_event(gate, node)
        self._path_gates[gate.full_path] = gate
        self._tbd.append((gate, node))
        return gate

    def _register_basic_event(self, node: XmlElement, base_path: str,
                              role: RoleSpecifier) -> BasicEvent:
        event = self._construct_role(BasicEvent, node, base_path, role)
        self._register_event(event, node)
        self._path_basic_events[event.full_path] = event
        self._tbd.append((event, node))
        return event

    def _register_house_event(self, node: XmlElement, base_path: str,
                              role: RoleSpecifier) -> HouseEvent:
        event = self._construct_role(HouseEvent, node, base_path, role)
        self._register_event(event, node)
        self._path_house_events[event.full_path] = event
        constant = node.child("constant")
        if constant is not None:
            event.state = constant.attribute("value", bool)
        return event

    def _register_parameter(self, node: XmlElement, base_path: str,
                            role: RoleSpecifier) -> Parameter:
        parameter = self._construct_role(Parameter, node, base_path, role)
        self._register(self.model.parameters, parameter, node)
        self._path_parameters[parameter.full_path] = parameter
        self._tbd.append((parameter, node))
        unit = node.attribute("unit")
        if unit is not None:
            if unit not in UNIT_BY_NAME:
                raise ValidityError(f"Unexpected parameter unit '{unit}'.",
                                    filename=node.filename, line=node.line)
            parameter.unit = UNIT_BY_NAME[unit]
        return parameter

    def _register_ccf_group(self, node: XmlElement, base_path: str,
                            role: RoleSpecifier) -> CcfGroup:
        model_name = node.attribute("model")
        ccf_classes = {"beta-factor": BetaFactorModel, "MGL": MglModel,
                       "alpha-factor": AlphaFactorModel,
                       "phi-factor": PhiFactorModel}
        if model_name not in ccf_classes:
            raise ValidityError(f"Unrecognized CCF model '{model_name}'.",
                                filename=node.filename, line=node.line)
        group = self._construct_role(ccf_classes[model_name], node, base_path,
                                     role)
        self._register(self.model.ccf_groups, group, node)
        members = node.child("members")
        if members is None:
            raise ValidityError(f"CCF group '{group.name}' has no members.",
                                filename=node.filename, line=node.line)
        self._process_ccf_members(members, group)
        self._tbd.append((group, node))
        return group

    def _process_ccf_members(self, members_node: XmlElement,
                             group: CcfGroup) -> None:
        for event_node in members_node.children():
            event = self._construct(BasicEvent, event_node, group.base_path,
                                    group.role)
            try:
                group.add_member(event)
            except (DuplicateElementError, ValidityError) as err:
                raise err.with_context(filename=event_node.filename,
                                       line=event_node.line)
            self._register_event(event, event_node)
            self._path_basic_events[event.full_path] = event

    def _register_event(self, event, node: XmlElement):
        try:
            if isinstance(event, Gate):
                self.model.add_gate(event)
            elif isinstance(event, BasicEvent):
                self.model.add_basic_event(event)
            else:
                self.model.add_house_event(event)
        except DuplicateElementError as err:
            raise err.with_context(filename=node.filename, line=node.line)

    # -- event trees -------------------------------------------------------

    def _define_event_tree(self, node: XmlElement) -> None:
        event_tree = self._construct(EventTree, node)
        for child in node.children():
            try:
                if child.name == "define-sequence":
                    sequence = self._construct(Sequence, child)
                    self._register(self.model.sequences, sequence, child)
                    self._tbd.append((sequence, child))
                    event_tree.sequences.add(sequence)
                elif child.name == "define-branch":
                    event_tree.branches.add(
                        self._construct(NamedBranch, child))
                elif child.name == "define-functional-event":
                    functional = self._construct(FunctionalEvent, child)
                    functional.order = len(event_tree.functional_events) + 1
                    event_tree.functional_events.add(functional)
            except (DuplicateElementError, ValidityError) as err:
                raise err.with_context(filename=child.filename,
                                       line=child.line)
        self._register(self.model.event_trees, event_tree, node)
        self._tbd.append((event_tree, node))

    # -- extern ------------------------------------------------------------

    def _define_extern_library(self, node: XmlElement) -> None:
        reference_dir = os.path.dirname(node.filename) \
            if node.filename != "<memory>" else ""
        library = ExternLibrary(
            node.attribute("name") or "",
            node.attribute("path") or "",
            reference_dir,
            bool(node.attribute("system", bool, False)),
            bool(node.attribute("decorate", bool, False)))
        _attach_label_and_attributes(node, library)
        self._register(self.model.libraries, library, node)

    def _define_extern_function(self, node: XmlElement) -> None:
        library = self.model.libraries.get(node.attribute("library") or "")
        library.usage = True
        type_nodes = _non_attribute_children(node)
        if not type_nodes:
            raise ValidityError(
                "Missing return type for extern function.",
                filename=node.filename, line=node.line)
        types = [t.name for t in type_nodes]
        function = ExternFunction(
            node.attribute("name") or "", node.attribute("symbol") or "",
            library, types[0], types[1:])
        self._register(self.model.extern_functions, function, node)

    # ==================================================================
    # Pass 2: definition (initializer.cpp:477-682).
    # ==================================================================

    def _process_tbd_elements(self) -> None:
        for document in self._documents:
            for node in document.root.children("define-extern-function"):
                self._define_extern_function(node)
        for element, node in self._tbd:
            try:
                if isinstance(element, Gate):
                    self._define_gate(node, element)
                elif isinstance(element, BasicEvent):
                    self._define_basic_event(node, element)
                elif isinstance(element, Parameter):
                    self._define_parameter(node, element)
                elif isinstance(element, CcfGroup):
                    self._define_ccf_group(node, element)
                elif isinstance(element, Sequence):
                    self._define_sequence(node, element)
                elif isinstance(element, EventTree):
                    self._define_event_tree_body(node, element)
                elif isinstance(element, InitiatingEvent):
                    self._define_initiating_event(node, element)
                elif isinstance(element, Rule):
                    self._define_rule(node, element)
                elif isinstance(element, Alignment):
                    self._define_alignment(node, element)
                elif isinstance(element, Substitution):
                    self._define_substitution(node, element)
                else:  # pragma: no cover - defensive
                    raise AssertionError(f"Unexpected TBD element: {element}")
            except (ValidityError, UndefinedElement) as err:
                raise err.with_context(filename=node.filename, line=node.line)

    def _define_gate(self, node: XmlElement, gate: Gate) -> None:
        formulas = _non_attribute_children(node)
        assert len(formulas) == 1, "Gate definition must have one formula."
        assert not gate.has_formula, "Resetting gate formula."
        gate.formula = self._get_formula(formulas[0], gate.base_path)

    def _define_basic_event(self, node: XmlElement,
                            event: BasicEvent) -> None:
        if event.has_expression:
            return  # CCF members get their expression from the group.
        expressions = _non_attribute_children(node)
        if expressions:
            event.expression = self._get_expression(expressions[0],
                                                    event.base_path)
        elif self.settings.probability_analysis():
            raise ValidityError(
                f"The basic event '{event.id}' does not have an expression.",
                filename=node.filename, line=node.line)

    def _define_parameter(self, node: XmlElement,
                          parameter: Parameter) -> None:
        expressions = _non_attribute_children(node)
        assert len(expressions) == 1, "Parameter must have one expression."
        parameter.expression = self._get_expression(expressions[0],
                                                    parameter.base_path)

    def _define_ccf_group(self, node: XmlElement, group: CcfGroup) -> None:
        for child in node.children():
            if child.name == "distribution":
                group.add_distribution(
                    self._get_expression(child.child(), group.base_path))
            elif child.name == "factor":
                self._define_ccf_factor(child, group)
            elif child.name == "factors":
                for factor_node in child.children():
                    self._define_ccf_factor(factor_node, group)

    def _define_ccf_factor(self, node: XmlElement, group: CcfGroup) -> None:
        expression = self._get_expression(node.child(), group.base_path)
        try:
            group.add_factor(expression, node.attribute("level", int))
        except ValidityError as err:
            raise err.with_context(filename=node.filename, line=node.line)

    def _define_sequence(self, node: XmlElement, sequence: Sequence) -> None:
        sequence.instructions = [self._get_instruction(child)
                                 for child in _non_attribute_children(node)]

    def _define_event_tree_body(self, node: XmlElement,
                                event_tree: EventTree) -> None:
        for child in node.children("define-branch"):
            branch = event_tree.branches.get(child.attribute("name"))
            self._define_branch(_non_attribute_children(child), event_tree,
                                branch)
        initial = node.child("initial-state")
        assert initial is not None, "Event tree must have an initial state."
        branch = Branch()
        self._define_branch(list(initial.children()), event_tree, branch)
        event_tree.initial_state = branch

    def _define_branch(self, nodes: list[XmlElement], event_tree: EventTree,
                       branch: Branch) -> None:
        assert nodes, "At least the branch target must be defined."
        branch.instructions = [self._get_instruction(n) for n in nodes[:-1]]
        self._define_branch_target(nodes[-1], event_tree, branch)

    def _define_branch_target(self, node: XmlElement, event_tree: EventTree,
                              branch: Branch) -> None:
        try:
            if node.name == "fork":
                functional = event_tree.functional_events.get(
                    node.attribute("functional-event"))
                paths = []
                for path_node in node.children("path"):
                    path = Path(path_node.attribute("state"))
                    self._define_branch(list(path_node.children()),
                                        event_tree, path)
                    paths.append(path)
                assert paths, "Fork must have at least one path."
                fork = Fork(functional, paths)
                branch.target = fork
                event_tree.forks.append(fork)
                functional.usage = True
            elif node.name == "sequence":
                sequence = self.model.sequences.get(node.attribute("name"))
                branch.target = sequence
                sequence.usage = True
            elif node.name == "branch":
                named = event_tree.branches.get(node.attribute("name"))
                branch.target = named
                named.usage = True
            else:
                raise ValidityError(
                    f"Invalid branch target '{node.name}'.")
        except (UndefinedElement, ValidityError) as err:
            raise err.with_context(filename=node.filename, line=node.line)

    def _define_initiating_event(self, node: XmlElement,
                                 initiating: InitiatingEvent) -> None:
        tree_name = node.attribute("event-tree")
        if tree_name:
            event_tree = self.model.event_trees.get(tree_name)
            initiating.event_tree = event_tree
            initiating.usage = True
            event_tree.usage = True

    def _define_rule(self, node: XmlElement, rule: Rule) -> None:
        rule.instructions = [self._get_instruction(child)
                             for child in _non_attribute_children(node)]

    def _define_alignment(self, node: XmlElement,
                          alignment: Alignment) -> None:
        for child in node.children("define-phase"):
            fraction = child.attribute("time-fraction", float)
            try:
                phase = Phase(child.attribute("name") or "", fraction)
            except ValidityError as err:
                raise err.with_context(filename=child.filename,
                                       line=child.line)
            _attach_label_and_attributes(child, phase)
            phase.instructions = [
                self._get_instruction(arg)
                for arg in child.children("set-house-event")]
            alignment.add(phase)
        try:
            alignment.validate()
        except ValidityError as err:
            raise err.with_context(filename=node.filename, line=node.line)

    def _define_substitution(self, node: XmlElement,
                             substitution: Substitution) -> None:
        hypothesis = node.child("hypothesis")
        assert hypothesis is not None
        substitution.hypothesis = self._get_formula(hypothesis.child(), "")
        source = node.child("source")
        if source is not None:
            for event_node in source.children():
                assert event_node.name == "basic-event"
                event = self._get_basic_event(
                    event_node.attribute("name"), "")
                substitution.add_source(event)
                event.usage = True
        target_node = node.child("target").child()
        if target_node.name == "basic-event":
            event = self._get_basic_event(target_node.attribute("name"), "")
            substitution.target = event
            event.usage = True
        else:
            assert target_node.name == "constant"
            substitution.target = target_node.attribute("value", bool)
        try:
            substitution.validate()
            declared = node.attribute("type")
            if declared:
                deduced = substitution.type()
                if deduced is None or SUBSTITUTION_TYPES[deduced] != declared:
                    raise ValidityError(
                        "The declared substitution type does not match the "
                        "deduced one.")
        except ValidityError as err:
            raise err.with_context(filename=node.filename, line=node.line)

    # ==================================================================
    # Formulas and instructions (initializer.cpp:772-984).
    # ==================================================================

    def _get_formula(self, node: XmlElement, base_path: str) -> Formula:
        if node.has_attribute("name") or node.name == "constant":
            connective = Connective.NULL
        else:
            if node.name not in CONNECTIVE_BY_NAME:
                raise ValidityError(f"Unexpected connective '{node.name}'.",
                                    filename=node.filename, line=node.line)
            connective = CONNECTIVE_BY_NAME[node.name]

        args: list[Arg] = []

        def add_event(element: XmlElement, complement: bool) -> None:
            element_type = element.attribute("type") or element.name
            name = element.attribute("name")
            assert name, "Not an appropriate XML element for an arg event."
            try:
                if element_type == "event":
                    event = self._get_event_arg(name, base_path)
                elif element_type == "gate":
                    event = self._get_gate(name, base_path)
                elif element_type == "basic-event":
                    event = self._get_basic_event(name, base_path)
                else:
                    assert element_type == "house-event"
                    event = self._get_house_event(name, base_path)
            except UndefinedElement as err:
                raise err.with_context(filename=element.filename,
                                       line=element.line)
            try:
                arg = Arg(event, complement)
                if any(a.event.id == arg.event.id for a in args):
                    raise DuplicateElementError(arg.event.id)
                args.append(arg)
                if not event.usage:
                    event.usage = True
            except DuplicateElementError as err:
                raise err.with_context(filename=element.filename,
                                       line=element.line)

        def add_arg(element: XmlElement) -> None:
            if element.name == "constant":
                value = element.attribute("value", bool)
                args.append(Arg(TRUE_EVENT if value else FALSE_EVENT))
                return
            if element.name == "not":
                children = list(element.children())
                assert len(children) == 1
                add_event(children[0], True)
            else:
                add_event(element, False)

        if connective is Connective.NULL:
            add_arg(node)
        else:
            for child in node.children():
                add_arg(child)

        try:
            return Formula(connective, args,
                           node.attribute("min", int),
                           node.attribute("max", int))
        except ValidityError as err:
            raise err.with_context(filename=node.filename, line=node.line)

    def _get_instruction(self, node: XmlElement):
        name = node.name
        if name == "rule":
            rule = self.model.rules.get(node.attribute("name"))
            rule.usage = True
            return rule
        if name == "event-tree":
            event_tree = self.model.event_trees.get(node.attribute("name"))
            event_tree.usage = True
            link = Link(event_tree)
            self.model.add_instruction(link)
            self._links.append(link)
            return link
        if name == "collect-expression":
            return self.model.add_instruction(
                CollectExpression(self._get_expression(node.child(), "")))
        if name == "collect-formula":
            return self.model.add_instruction(
                CollectFormula(self._get_formula(node.child(), "")))
        if name == "if":
            children = _non_attribute_children(node)
            expression = self._get_expression(children[0], "")
            then_instruction = self._get_instruction(children[1])
            else_instruction = (self._get_instruction(children[2])
                                if len(children) > 2 else None)
            return self.model.add_instruction(
                IfThenElse(expression, then_instruction, else_instruction))
        if name == "block":
            return self.model.add_instruction(Block(
                [self._get_instruction(child) for child in node.children()]))
        if name == "set-house-event":
            event_name = node.attribute("name")
            if event_name not in self.model.house_events:
                raise UndefinedElement(event_name, "house event",
                                       filename=node.filename, line=node.line)
            return self.model.add_instruction(SetHouseEvent(
                event_name, node.child().attribute("value", bool)))
        raise ValidityError(f"Unknown instruction type '{name}'.",
                            filename=node.filename, line=node.line)

    # ==================================================================
    # Expressions (initializer.cpp:1061-1289).
    # ==================================================================

    _NARY = {"neg": Neg, "add": Add, "sub": Sub, "mul": Mul, "div": Div,
             "abs": Abs, "acos": Acos, "asin": Asin, "atan": Atan,
             "cos": Cos, "sin": Sin, "tan": Tan, "cosh": Cosh, "sinh": Sinh,
             "tanh": Tanh, "exp": Exp, "log": Log, "log10": Log10,
             "mod": Mod, "pow": Pow, "sqrt": Sqrt, "ceil": Ceil,
             "floor": Floor, "min": Min, "max": Max, "mean": Mean,
             "not": Not, "and": And, "or": Or, "eq": Eq, "df": Df, "lt": Lt,
             "gt": Gt, "leq": Leq, "geq": Geq}
    _FIXED = {"exponential": (Exponential, 2), "GLM": (Glm, 4),
              "Weibull": (Weibull, 4), "uniform-deviate": (UniformDeviate, 2),
              "normal-deviate": (NormalDeviate, 2),
              "gamma-deviate": (GammaDeviate, 2),
              "beta-deviate": (BetaDeviate, 2)}

    def _get_expression(self, node: XmlElement, base_path: str):
        expr_type = node.name
        model = self.model

        if expr_type == "int":
            return model.add_expression(
                ConstantExpression(node.attribute("value", int)))
        if expr_type == "float":
            return model.add_expression(
                ConstantExpression(node.attribute("value", float)))
        if expr_type == "bool":
            return ONE if node.attribute("value", bool) else ZERO
        if expr_type == "pi":
            return PI
        if expr_type == "test-initiating-event":
            return model.add_expression(TestInitiatingEvent(
                node.attribute("name") or "", model.context))
        if expr_type == "test-functional-event":
            return model.add_expression(TestFunctionalEvent(
                node.attribute("name") or "", node.attribute("state") or "",
                model.context))
        if expr_type == "extern-function":
            function = model.extern_functions.get(node.attribute("name"))
            function.usage = True
            expr_args = [self._get_expression(child, base_path)
                         for child in node.children()]
            try:
                expression = function.apply(expr_args)
            except ValidityError as err:
                raise err.with_context(filename=node.filename, line=node.line)
            return model.add_expression(expression)
        if expr_type == "parameter":
            parameter = self._get_parameter(node.attribute("name"), base_path)
            parameter.usage = True
            self._check_units(node, parameter)
            return parameter
        if expr_type == "system-mission-time":
            self._check_units(node, model.mission_time)
            return model.mission_time

        try:
            expression = self._extract_expression(expr_type, node, base_path)
        except ValidityError as err:
            raise err.with_context(filename=node.filename, line=node.line)
        model.add_expression(expression)
        self._expressions.append((expression, node))
        return expression

    def _extract_expression(self, expr_type: str, node: XmlElement,
                            base_path: str):
        children = _non_attribute_children(node)
        get = lambda n: self._get_expression(n, base_path)  # noqa: E731

        if expr_type in self._NARY:
            return self._NARY[expr_type]([get(c) for c in children])
        if expr_type in self._FIXED:
            cls, arity = self._FIXED[expr_type]
            if len(children) != arity:
                raise ValidityError(
                    f"'{expr_type}' requires {arity} arguments, "
                    f"got {len(children)}.")
            return cls(*(get(c) for c in children))
        if expr_type == "lognormal-deviate":
            if len(children) not in (2, 3):
                raise ValidityError(
                    "'lognormal-deviate' requires 2 or 3 arguments, "
                    f"got {len(children)}.")
            return LognormalDeviate(*(get(c) for c in children))
        if expr_type == "periodic-test":
            return PeriodicTest(*(get(c) for c in children))
        if expr_type == "histogram":
            # <histogram><float .../><bin><b/><w/></bin>...</histogram>
            boundaries = [get(children[0])]
            weights = []
            for bin_node in children[1:]:
                bin_children = _non_attribute_children(bin_node)
                assert len(bin_children) == 2, "Histogram bin needs 2 values."
                boundaries.append(get(bin_children[0]))
                weights.append(get(bin_children[1]))
            if not weights:
                raise ValidityError("Histogram requires at least one bin.")
            return Histogram(boundaries, weights)
        if expr_type == "ite":
            if len(children) != 3:
                raise ValidityError("'ite' requires 3 arguments.")
            return Ite(*(get(c) for c in children))
        if expr_type == "switch":
            cases = []
            default = None
            for i, child in enumerate(children):
                if i == len(children) - 1:
                    default = get(child)
                    break
                case_children = _non_attribute_children(child)
                assert len(case_children) == 2, "Switch case needs 2 values."
                cases.append((get(case_children[0]), get(case_children[1])))
            assert default is not None, "Switch requires a default value."
            return Switch(cases, default)
        raise ValidityError(f"Unknown expression type '{expr_type}'.")

    def _check_units(self, node: XmlElement, parameter) -> None:
        unit = node.attribute("unit")
        if unit and unit != UNIT_NAMES[parameter.unit]:
            raise ValidityError(
                f"Parameter unit mismatch. Expected: "
                f"{UNIT_NAMES[parameter.unit]}. Given: {unit}.",
                filename=node.filename, line=node.line)

    # ==================================================================
    # Scoped reference resolution (initializer.cpp:1354-1439).
    # ==================================================================

    def _get_entity(self, reference: str, base_path: str, public_table,
                    path_table: dict, kind: str):
        assert reference
        if base_path:
            local = path_table.get(f"{base_path}.{reference}")
            if local is not None:
                return local
        if "." not in reference:
            found = public_table.find(reference)
            if found is None:
                raise UndefinedElement(reference, kind)
            return found
        found = path_table.get(reference)
        if found is None:
            raise UndefinedElement(reference, kind)
        return found

    def _get_parameter(self, reference: str, base_path: str) -> Parameter:
        return self._get_entity(reference, base_path, self.model.parameters,
                                self._path_parameters, "parameter")

    def _get_gate(self, reference: str, base_path: str) -> Gate:
        return self._get_entity(reference, base_path, self.model.gates,
                                self._path_gates, "gate")

    def _get_basic_event(self, reference: str, base_path: str) -> BasicEvent:
        return self._get_entity(reference, base_path, self.model.basic_events,
                                self._path_basic_events, "basic event")

    def _get_house_event(self, reference: str, base_path: str) -> HouseEvent:
        return self._get_entity(reference, base_path, self.model.house_events,
                                self._path_house_events, "house event")

    def _get_event_arg(self, reference: str, base_path: str):
        """Type-agnostic event lookup (initializer.cpp:1416-1439)."""
        if base_path:
            full = f"{base_path}.{reference}"
            for table in (self._path_gates, self._path_basic_events,
                          self._path_house_events):
                found = table.get(full)
                if found is not None:
                    return found
        if "." not in reference:
            for table in (self.model.gates, self.model.basic_events,
                          self.model.house_events):
                found = table.find(reference)
                if found is not None:
                    return found
        else:
            for table in (self._path_gates, self._path_basic_events,
                          self._path_house_events):
                found = table.get(reference)
                if found is not None:
                    return found
        raise UndefinedElement(reference, "event")

    # ==================================================================
    # Validation battery (initializer.cpp:1606-1885).
    # ==================================================================

    def _validate_initialization(self) -> None:
        cycle.check_cycle(self.model.gates, cycle.gate_successors, "gate")
        cycle.check_cycle(self.model.rules, cycle.rule_successors, "rule")
        for event_tree in self.model.event_trees:
            try:
                cycle.check_cycle(event_tree.branches,
                                  cycle.branch_successors, "branch")
            except Exception as err:
                if hasattr(err, "with_context"):
                    raise err.with_context(element=event_tree.name,
                                           element_type="event tree")
                raise

        for event_tree in self.model.event_trees:
            for branch in event_tree.branches:
                self._check_functional_order(branch)
                self._ensure_links_only_in_sequences(branch)
            self._check_functional_order(event_tree.initial_state)
            self._ensure_links_only_in_sequences(event_tree.initial_state)

        cycle.check_cycle(self._links, cycle.link_successors,
                          "event-tree link")

        for event_tree in self.model.event_trees:
            for branch in event_tree.branches:
                self._ensure_homogeneous(branch)
            self._ensure_homogeneous(event_tree.initial_state)

        self._ensure_no_substitution_conflicts()
        self._validate_expressions()

    def _check_functional_order(self, branch: Branch) -> None:
        """Forks must respect functional-event order; no duplicates
        (initializer.cpp:1659-1698)."""
        target = branch.target
        if not isinstance(target, Fork):
            return
        fork = target
        for path in fork.paths:
            self._check_functional_order(path)
            inner = path.target
            if isinstance(inner, Fork):
                if fork.functional_event.order == \
                        inner.functional_event.order:
                    raise ValidityError(
                        f"Functional event '{fork.functional_event.name}' is "
                        "duplicated in event tree fork paths.")
                if fork.functional_event.order > \
                        inner.functional_event.order:
                    raise ValidityError(
                        f"Functional event '{inner.functional_event.name}' "
                        "must appear before functional event "
                        f"'{fork.functional_event.name}' in event tree fork "
                        "paths.")
            elif isinstance(inner, NamedBranch):
                self._check_order_against(fork, inner)

    def _check_order_against(self, fork: Fork, named: NamedBranch) -> None:
        inner = named.target
        if isinstance(inner, Fork):
            if fork.functional_event.order == inner.functional_event.order:
                raise ValidityError(
                    f"Functional event '{fork.functional_event.name}' is "
                    "duplicated in event tree fork paths.")
            if fork.functional_event.order > inner.functional_event.order:
                raise ValidityError(
                    f"Functional event '{inner.functional_event.name}' must "
                    "appear before functional event "
                    f"'{fork.functional_event.name}' in event tree fork "
                    "paths.")
        elif isinstance(inner, NamedBranch):
            self._check_order_against(fork, inner)

    def _ensure_links_only_in_sequences(self, branch: Branch) -> None:
        """Link instructions only in end-state sequences
        (initializer.cpp:1700-1726)."""
        collector = cycle._RuleCollector()
        for instruction in branch.instructions:
            instruction.accept(collector)
        if collector.links:
            raise ValidityError(
                f"Link '{collector.links[0].event_tree.name}' can only be "
                "used in end-state sequences.")
        target = branch.target
        if isinstance(target, Fork):
            for path in target.paths:
                self._ensure_links_only_in_sequences(path)

    def _ensure_homogeneous(self, branch: Branch) -> None:
        """No mixing of collect-expression and collect-formula
        (initializer.cpp:1728-1781)."""
        kinds: set[str] = set()

        def scan_instructions(instructions):
            for instruction in instructions:
                if isinstance(instruction, CollectExpression):
                    kinds.add("expression")
                elif isinstance(instruction, CollectFormula):
                    kinds.add("formula")
                elif isinstance(instruction, Block):
                    scan_instructions(instruction.instructions)
                elif isinstance(instruction, Rule):
                    scan_instructions(instruction.instructions)
                elif isinstance(instruction, IfThenElse):
                    scan_instructions(
                        [i for i in (instruction.then_instruction,
                                     instruction.else_instruction) if i])
                elif isinstance(instruction, Link):
                    walk(instruction.event_tree.initial_state)
                if len(kinds) > 1:
                    raise ValidityError(
                        "Mixed collect-expression and collect-formula in "
                        "event tree paths.")

        def walk(b: Branch):
            scan_instructions(b.instructions)
            target = b.target
            if isinstance(target, Fork):
                for path in target.paths:
                    walk(path)
            elif isinstance(target, Sequence):
                scan_instructions(target.instructions)
            elif isinstance(target, NamedBranch):
                pass  # Checked on its own.

        walk(branch)

    def _ensure_no_substitution_conflicts(self) -> None:
        """initializer.cpp:1783-1816 semantics."""
        non_declarative = [s for s in self.model.substitutions
                           if not s.declarative]
        for origin in non_declarative:
            target = origin.target if isinstance(origin.target, BasicEvent) \
                else None
            for substitution in non_declarative:
                if target is not None and any(
                        s is target for s in substitution.source):
                    raise ValidityError(
                        "Non-declarative substitution target event should "
                        "not appear in any substitution source.",
                        element=origin.name, element_type="substitution")
                if origin is substitution:
                    continue

                def in_hypothesis(event):
                    return any(arg.event is event
                               for arg in substitution.hypothesis.args)

                if target is not None and in_hypothesis(target):
                    raise ValidityError(
                        "Non-declarative substitution target event should "
                        "not appear in another substitution hypothesis.",
                        element=origin.name, element_type="substitution")
                if any(in_hypothesis(source) for source in origin.source):
                    raise ValidityError(
                        "Non-declarative substitution source event should "
                        "not appear in another substitution hypothesis.",
                        element=origin.name, element_type="substitution")

    def _validate_expressions(self) -> None:
        """initializer.cpp:1860-1885."""
        cycle.check_cycle(self.model.parameters, cycle.parameter_successors,
                          "parameter")
        for expression, node in self._expressions:
            try:
                expression.validate()
            except ValidityError as err:
                raise err.with_context(filename=node.filename, line=node.line)
        for group in self.model.ccf_groups:
            group.validate()
        if self.settings.probability_analysis():
            for event in self.model.basic_events:
                if event.has_expression:
                    event.validate()

    # ==================================================================
    # Setup for analysis (initializer.cpp:1887-1903).
    # ==================================================================

    def _setup_for_analysis(self) -> None:
        for gate in self.model.gates:
            gate.mark = None
        for fault_tree in self.model.fault_trees:
            fault_tree.collect_top_events()
        for group in self.model.ccf_groups:
            group.apply_model()

    def _ensure_no_ccf_substitutions(self) -> None:
        """initializer.cpp:1818-1846."""
        for substitution in self.model.substitutions:
            if substitution.declarative:
                continue
            has_ccf = any(
                isinstance(arg.event, BasicEvent) and arg.event.has_ccf
                for arg in substitution.hypothesis.args)
            if isinstance(substitution.target, BasicEvent) and \
                    substitution.target.has_ccf:
                has_ccf = True
            if any(source.has_ccf for source in substitution.source):
                has_ccf = True
            if has_ccf:
                raise ValidityError(
                    f"Non-declarative substitution '{substitution.name}' "
                    "events cannot be in a CCF group.")

    def _ensure_substitutions_with_approximations(self) -> None:
        """initializer.cpp:1848-1858."""
        if self.settings.approximation() != Approximation.NONE:
            return
        if any(not s.declarative for s in self.model.substitutions):
            raise ValidityError(
                "Non-declarative substitutions do not apply to exact "
                "analyses.")
