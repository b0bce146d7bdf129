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
* RELAX NG validation has no standard-library engine: asking for it
  raises :class:`~canopy_tpu_torch.errors.IllegalOperation`.
"""

from __future__ import annotations

import copy
import re
import xml.etree.ElementTree as ET
from typing import Iterator
from xml.etree import ElementInclude
from xml.parsers import expat

from ..errors import (IllegalOperation, XIncludeError, XmlParseError,
                      XmlValidityError)

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


class Validator:
    """RELAX NG validation: not available without lxml."""

    def __init__(self, schema_path: str):
        raise IllegalOperation(
            "RELAX NG validation needs lxml, which this installation "
            "does not have; run without --validate (or validate with the "
            "canopy_tpu package)")


class Document:
    """A parsed MEF input file, XInclude-resolved (no network access)."""

    def __init__(self, file_path: str, validator: Validator | None = None):
        self._filename = file_path
        self._root = _parse_file(file_path)
        _resolve_includes(self._root, file_path)

    @classmethod
    def from_string(cls, text: str, filename: str = "<memory>",
                    validator: Validator | None = None) -> "Document":
        """Parse from an in-memory string (used heavily by tests)."""
        self = cls.__new__(cls)
        # Like lxml's docinfo.URL, an in-memory document has no URL:
        # ``filename`` only labels parse errors.
        self._filename = "<memory>"
        self._root = _parse(lambda p: p.Parse(text.encode(), True),
                            filename)
        _resolve_includes(self._root, filename)
        return self

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def root(self) -> Element:
        return Element(self._root, self._filename)
