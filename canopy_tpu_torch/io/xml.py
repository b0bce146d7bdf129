"""Strict XML ingestion for OpenPSA-MEF input files, on the standard library.

The same surface as ``canopy_tpu.io.xml`` (:class:`Document`,
:class:`Element`, :class:`Validator`, the strict ``to_*`` parsers), built
on ``xml.parsers.expat`` and ``xml.etree`` instead of lxml, which the GPU
machine does not have:

* the tree is built straight from expat events, so every element records
  expat's ``CurrentLineNumber`` (model errors keep their file:line);
* XInclude resolves through ``xml.etree.ElementInclude`` with a loader
  that reads local files only (no network access, as with lxml's
  ``no_network``);
* RELAX NG validation has no standard-library engine.  One grammar is
  checked by hand, the bundled project grammar (``schemas/project.rng``):
  :class:`Validator` on it gives the verdicts lxml's RELAX NG engine
  gives, and on any other grammar raises
  :class:`~canopy_tpu_torch.errors.IllegalOperation`.
"""

from __future__ import annotations

import copy
import os
import re
import xml.etree.ElementTree as ET
from typing import Iterator
from xml.etree import ElementInclude
from xml.parsers import expat

from ..errors import (IllegalOperation, ValidityError, XIncludeError,
                      XmlParseError, XmlValidityError)
from ..schemas import project_schema_path

__all__ = ["Document", "Element", "Validator", "to_bool", "to_int", "to_float"]

_TRUE = {"true", "1"}
_FALSE = {"false", "0"}

# Strict number grammars: reject partial parses like "1.5x" or "" that
# Python's int()/float() plus stripping could otherwise let through oddly.
_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def to_bool(text: str) -> bool:
    """Strict xs:boolean parse ('true'/'false'/'1'/'0')."""
    text = text.strip()
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    raise ValueError(f"Failed to interpret value '{text}' as boolean.")


def to_int(text: str) -> int:
    """Strict integer parse (whole-string match only)."""
    text = text.strip()
    if not _INT_RE.match(text):
        raise ValueError(f"Failed to interpret value '{text}' as int.")
    return int(text)


def to_float(text: str) -> float:
    """Strict floating-point parse (whole-string match only)."""
    text = text.strip()
    if not _FLOAT_RE.match(text):
        raise ValueError(f"Failed to interpret value '{text}' as float.")
    return float(text)


_CONVERTERS = {bool: to_bool, int: to_int, float: to_float, str: lambda s: s.strip()}


class _Node(ET.Element):
    """An ``ElementTree`` element that remembers its source line (and
    keeps it through the shallow copy ``ElementInclude`` makes of an
    included root)."""

    sourceline = 0

    def __copy__(self):
        new = _Node(self.tag, self.attrib)
        new.text, new.tail = self.text, self.tail
        new[:] = list(self)
        new.sourceline = self.sourceline
        return new


def _fixname(name: str) -> str:
    # expat reports "uri}local" with namespace_separator="}".
    return "{" + name if "}" in name else name


def _parse(feed, filename: str) -> _Node:
    """Build a line-numbered tree from expat events; ``feed(parser)``
    runs the parse (``Parse`` on bytes or ``ParseFile`` on a file)."""
    parser = expat.ParserCreate(namespace_separator="}")
    builder = ET.TreeBuilder(element_factory=_Node)

    def start(tag, attrs):
        node = builder.start(_fixname(tag),
                             {_fixname(k): v for k, v in attrs.items()})
        node.sourceline = parser.CurrentLineNumber

    parser.StartElementHandler = start
    parser.EndElementHandler = lambda tag: builder.end(_fixname(tag))
    parser.CharacterDataHandler = builder.data
    try:
        feed(parser)
    except expat.ExpatError as exc:
        raise XmlParseError(str(exc), filename=filename,
                            line=exc.lineno) from exc
    return builder.close()


def _parse_file(path: str) -> _Node:
    try:
        with open(path, "rb") as fh:
            return _parse(lambda p: p.ParseFile(fh), path)
    except OSError as exc:
        raise XmlParseError(f"Cannot read input file: {exc}",
                            filename=path) from exc


def _include_loader(href: str, parse: str, encoding: str | None = None):
    """Local-file XInclude loader (``href`` arrives joined to the
    including document's path)."""
    if "://" in href:
        raise XIncludeError(f"XInclude of a non-local resource '{href}' "
                            "is not allowed", filename=href)
    if parse == "xml":
        return copy.copy(_parse_file(href))
    with open(href, encoding=encoding or "utf-8") as fh:
        return fh.read()


def _resolve_includes(root: _Node, filename: str) -> None:
    try:
        ElementInclude.include(root, loader=_include_loader,
                               base_url=filename)
    except (ElementInclude.FatalIncludeError, OSError) as exc:
        raise XIncludeError(str(exc), filename=filename) from exc


class Element:
    """Immutable adaptor over an XML element node.

    Mirrors the access surface of the reference ``io::xml::element``:
    ``name``, ``filename``, ``line``, ``has_attribute``, ``attribute``
    (trimmed, optionally typed), ``text`` (typed), ``child``, ``children``
    (optionally name-filtered).
    """

    __slots__ = ("_node", "_filename")

    def __init__(self, node, filename: str = "<memory>"):
        self._node = node
        self._filename = filename

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._node.tag.rpartition("}")[2]

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def line(self) -> int:
        return getattr(self._node, "sourceline", 0) or 0

    # -- attributes --------------------------------------------------------
    def has_attribute(self, name: str) -> bool:
        return name in self._node.attrib

    def attribute(self, name: str, type_=str, default=None):
        """Typed, trimmed attribute access.

        Returns ``default`` when the attribute is missing. Raises
        :class:`XmlValidityError` (with file:line) on a failed typed parse.
        """
        raw = self._node.get(name)
        if raw is None:
            return default
        try:
            return _CONVERTERS[type_](raw)
        except ValueError as exc:
            raise XmlValidityError(str(exc), filename=self.filename,
                                   line=self.line) from exc

    # -- text --------------------------------------------------------------
    def text(self, type_=str):
        raw = self._node.text or ""
        try:
            return _CONVERTERS[type_](raw)
        except ValueError as exc:
            raise XmlValidityError(str(exc), filename=self.filename,
                                   line=self.line) from exc

    # -- children ----------------------------------------------------------
    def child(self, name: str | None = None) -> "Element | None":
        """The first child element (optionally restricted by name)."""
        return next(self.children(name), None)

    def children(self, name: str | None = None) -> Iterator["Element"]:
        """Iterate child elements in document order, optionally
        name-filtered (the reference ``range`` view semantics,
        ``src/io/xml/range.h:11-69``)."""
        for node in self._node:
            if name is None or node.tag.rpartition("}")[2] == name:
                yield Element(node, self._filename)

    def num_children(self, name: str | None = None) -> int:
        return sum(1 for _ in self.children(name))

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Element {self.name} at {self.filename}:{self.line}>"


# The project grammar's datatypes, by their xsd lexical forms after
# whitespace collapsing (libxml2's forms: a double's exponent may have no
# digits, "+INF" is not one).
_XSD_TYPES = {
    "boolean": re.compile(r"(true|false|1|0)\Z"),
    "nonNegativeInteger": re.compile(r"(\+?[0-9]+|-0+)\Z"),
    "positiveInteger": re.compile(r"\+?0*[1-9][0-9]*\Z"),
    "double": re.compile(r"([+-]?([0-9]+\.?[0-9]*|\.[0-9]+)"
                         r"([eE][+-]?[0-9]*)?|-?INF|NaN)\Z"),
}
_XML_SPACE = " \t\n\r"
_ANALYSIS_ATTRIBUTES = dict.fromkeys(
    ("probability", "importance", "uncertainty", "ccf", "sil",
     "prime-implicants", "skip-products"), "boolean")
_LIMITS_ATTRIBUTES = {
    "limit-order": "nonNegativeInteger", "cut-off": "double",
    "num-trials": "positiveInteger", "batch-size": "positiveInteger",
    "sample-size": "positiveInteger", "num-quantiles": "positiveInteger",
    "num-bins": "positiveInteger", "seed": "nonNegativeInteger",
    "mission-time": "double", "time-step": "double"}
#: ``options``' interleave: each child at most once, in any order; the
#: ``value`` choices of the two enumerations, or the typed attributes.
_OPTION_CHILDREN = {
    "algorithm": ("bdd", "zbdd", "mocus", "pdag", "direct"),
    "approximation": ("none", "rare-event", "mcub", "monte-carlo"),
    "analysis": _ANALYSIS_ATTRIBUTES,
    "limits": _LIMITS_ATTRIBUTES,
}


class _ProjectChecker:
    """The project grammar (``schemas/project.rng``) as code: the element
    order and counts, the attributes and their datatypes, and no text
    where the grammar has none (whitespace aside)."""

    def __init__(self, filename: str):
        self.filename = filename

    def fail(self, node, msg: str):
        raise ValidityError(msg, filename=self.filename,
                            line=getattr(node, "sourceline", None))

    def no_text(self, node) -> None:
        for text in [node.text] + [child.tail for child in node]:
            if text and text.strip(_XML_SPACE):
                self.fail(node, f"Element {node.tag} has unexpected text "
                                f"{text.strip(_XML_SPACE)!r}")

    def attributes(self, node, allowed: dict, required=()) -> None:
        for name, value in node.attrib.items():
            if name not in allowed:
                self.fail(node, f"Invalid attribute {name} for element "
                                f"{node.tag}")
            kind = allowed[name]
            collapsed = re.sub(r"[ \t\n\r]+", " ",
                               value).strip(_XML_SPACE)
            if isinstance(kind, tuple):
                ok, want = collapsed in kind, "one of " + ", ".join(kind)
            else:
                ok = kind is None or bool(_XSD_TYPES[kind].match(collapsed))
                want = kind
            if not ok:
                self.fail(node, f"Value {value!r} of attribute {name} of "
                                f"element {node.tag} is not {want}")
        for name in required:
            if name not in node.attrib:
                self.fail(node, f"Element {node.tag} lacks attribute "
                                f"{name}")

    def leaf(self, node, allowed: dict, required=()) -> None:
        self.attributes(node, allowed, required)
        self.no_text(node)
        if len(node):
            self.fail(node[0], f"Element {node[0].tag} is not allowed in "
                               f"{node.tag}")

    def leaf_free(self, node) -> None:
        """An element that holds elements only: no attributes, no text."""
        self.attributes(node, {})
        self.no_text(node)

    def check(self, root) -> None:
        if root.tag != "canopy-project":
            self.fail(root, f"Expecting element canopy-project, got "
                            f"{root.tag}")
        self.leaf_free(root)
        children = list(root)
        names = [child.tag for child in children]
        expected = ["input-files"] + [
            n for n in ("options", "output") if n in names]
        if names != expected:
            where = next((c for c, e in zip(children, expected)
                          if c.tag != e), children[-1] if children
                         else root)
            self.fail(where, f"Element canopy-project holds {names}; the "
                             "grammar wants input-files, then at most one "
                             "options, then at most one output")
        files, *rest = children
        self.leaf_free(files)
        if not len(files):
            self.fail(files, "Element input-files holds no file")
        for node in files:
            if node.tag != "file":
                self.fail(node, f"Element {node.tag} is not allowed in "
                                "input-files")
            self.attributes(node, {})
            if len(node):
                self.fail(node[0], f"Element {node[0].tag} is not allowed "
                                   "in file")
        for node in rest:
            if node.tag == "output":
                self.leaf(node, {"file": None}, required=("file",))
                continue
            self.leaf_free(node)
            seen = set()
            for option in node:
                allowed = _OPTION_CHILDREN.get(option.tag)
                if allowed is None or option.tag in seen:
                    self.fail(option, f"Element {option.tag} is not "
                                      "allowed here in options")
                seen.add(option.tag)
                if isinstance(allowed, tuple):
                    self.leaf(option, {"value": allowed},
                              required=("value",))
                else:
                    self.leaf(option, allowed)


class Validator:
    """Validation against the bundled project grammar, by hand.

    RELAX NG needs lxml, which this installation does not have, so only
    ``schemas/project.rng`` is supported: its element structure,
    attributes and xsd datatypes are checked in code, with the verdicts
    of lxml's RELAX NG engine.  Any other grammar raises
    :class:`IllegalOperation`.
    """

    def __init__(self, schema_path: str):
        if not (os.path.isfile(schema_path) and os.path.samefile(
                schema_path, project_schema_path())):
            raise IllegalOperation(
                "RELAX NG validation needs lxml, which this installation "
                "does not have; run without --validate (or validate with "
                "the canopy_tpu package)")

    def validate(self, document: "Document") -> None:
        """Raise :class:`ValidityError` (file and line) where the
        document breaks the project grammar."""
        _ProjectChecker(document._label).check(document._root)


class Document:
    """A parsed MEF input file, XInclude-resolved (no network access)."""

    def __init__(self, file_path: str, validator: Validator | None = None):
        self._filename = self._label = file_path
        self._root = _parse_file(file_path)
        _resolve_includes(self._root, file_path)
        if validator is not None:
            validator.validate(self)

    @classmethod
    def from_string(cls, text: str, filename: str = "<memory>",
                    validator: Validator | None = None) -> "Document":
        """Parse from an in-memory string (used heavily by tests)."""
        self = cls.__new__(cls)
        # Like lxml's docinfo.URL, an in-memory document has no URL:
        # ``filename`` only labels parse errors.
        self._filename = "<memory>"
        self._label = filename
        self._root = _parse(lambda p: p.Parse(text.encode(), True),
                            filename)
        _resolve_includes(self._root, filename)
        if validator is not None:
            validator.validate(self)
        return self

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def root(self) -> Element:
        return Element(self._root, self._filename)
