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
* RELAX NG validation has no standard-library engine, so
  :class:`Validator` interprets the grammar itself (Clark's derivative
  algorithm) in the subset the bundled grammars use; a construct outside
  it raises :class:`~canopy_tpu_torch.errors.IllegalOperation`.  Its
  verdicts are lxml's RELAX NG engine's.
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


# ---------------------------------------------------------------------------
# RELAX NG: a grammar interpreter (Clark's derivative algorithm).
# ---------------------------------------------------------------------------

_RNG_NS = "http://relaxng.org/ns/structure/1.0"
_XSD_LIB = "http://www.w3.org/2001/XMLSchema-datatypes"
#: The xsd datatypes the bundled grammars use, by their lexical forms after
#: whitespace collapsing (libxml2's forms: a double's exponent may have no
#: digits, "+INF" is not one).
_XSD_TYPES = {
    "boolean": re.compile(r"(true|false|1|0)\Z"),
    "integer": re.compile(r"[+-]?[0-9]+\Z"),
    "nonNegativeInteger": re.compile(r"(\+?[0-9]+|-0+)\Z"),
    "positiveInteger": re.compile(r"\+?0*[1-9][0-9]*\Z"),
    "double": re.compile(r"([+-]?([0-9]+\.?[0-9]*|\.[0-9]+)"
                         r"([eE][+-]?[0-9]*)?|-?INF|NaN)\Z"),
}
_XML_SPACE = " \t\n\r"
#: The grammar elements the interpreter takes; any other raises.
_SUPPORTED = {"grammar", "start", "define", "ref", "element", "attribute",
              "group", "choice", "interleave", "optional", "zeroOrMore",
              "oneOrMore", "text", "empty", "value", "data"}
_EMPTY, _NOT_ALLOWED, _TEXT = "empty", "notAllowed", "text"
_CHOICE, _GROUP, _INTERLEAVE, _ONE_OR_MORE = ("choice", "group",
                                              "interleave", "oneOrMore")
_AFTER, _ELEMENT, _ATTRIBUTE = "after", "element", "attribute"
_VALUE, _DATA = "value", "data"


def _collapse(text: str) -> str:
    """xsd whitespace collapsing (XML whitespace only)."""
    return re.sub(r"[ \t\n\r]+", " ", text).strip(_XML_SPACE)


def _local_name(tag: str) -> str:
    return tag.rpartition("}")[2]


class _Pat:
    """A pattern node: interned (equal patterns are one object), so
    identity is equality and derivatives memoize on ``id``."""

    __slots__ = ("kind", "a", "b", "nullable", "__weakref__")

    def __init__(self, kind: str, a=None, b=None, nullable=False):
        self.kind, self.a, self.b, self.nullable = kind, a, b, nullable


class _Element(_Pat):
    """An ``element`` of the grammar: its name and (built on first use,
    so recursive grammars terminate) its content."""

    __slots__ = ("build", "_content")

    def __init__(self, name: tuple, build):
        super().__init__(_ELEMENT, name)
        self.build, self._content = build, None

    @property
    def content(self) -> _Pat:
        if self._content is None:
            self._content = self.build()
        return self._content


class _Grammar:
    """A RELAX NG grammar in the supported subset, and the derivatives of
    its patterns (Clark, "An algorithm for RELAX NG validation")."""

    def __init__(self, path: str):
        self.path = path
        self._interned: dict = {}
        self.empty = _Pat(_EMPTY, nullable=True)
        self.not_allowed = _Pat(_NOT_ALLOWED)
        self.text = _Pat(_TEXT, nullable=True)
        self._memo: dict = {}
        root = _parse_file(path)
        if root.tag != f"{{{_RNG_NS}}}grammar":
            self._refuse(root)
        self._defines: dict = {}
        self._define_pats: dict = {}
        start = None
        for node in self._rng_children(root):
            name = _local_name(node.tag)
            if name == "start":
                start = node
            elif name == "define":
                if "combine" in node.attrib:
                    raise IllegalOperation(
                        f"RELAX NG construct 'define combine' ({path}:"
                        f"{node.sourceline}) is not supported")
                self._defines[node.get("name")] = node
            else:
                self._refuse(node)
        if start is None:
            raise XmlParseError("Invalid RELAX NG schema: no start",
                                filename=path)
        self._root_ctx = self._context(root, ("", ""))
        self._elements: list[_Element] = []
        self.start = self._group(start, self._root_ctx)
        # Build every define and element content now, so that a construct
        # outside the subset raises here, not when a document reaches it.
        for name in self._defines:
            self._ref_named(name, start)
        for element in self._elements:      # The list grows as it goes.
            element.content

    # -- grammar parsing --------------------------------------------------
    def _refuse(self, node):
        raise IllegalOperation(
            f"RELAX NG construct '{_local_name(node.tag)}' ({self.path}:"
            f"{node.sourceline}) is not supported by this validator (it "
            f"takes: {', '.join(sorted(_SUPPORTED))})")

    @staticmethod
    def _rng_children(node):
        """Grammar children; elements of other namespaces are annotations
        and are skipped, as the RELAX NG specification says."""
        return [c for c in node if c.tag.startswith(f"{{{_RNG_NS}}}")]

    def _context(self, node, ctx: tuple) -> tuple:
        ns, lib = ctx
        return (node.get("ns", ns), node.get("datatypeLibrary", lib))

    def _group(self, node, ctx: tuple) -> _Pat:
        """The children of ``node`` as one pattern (a group)."""
        ctx = self._context(node, ctx)
        pats = [self._pattern(c, ctx) for c in self._rng_children(node)]
        if not pats:
            return self.empty
        out = pats[0]
        for p in pats[1:]:
            out = self.group(out, p)
        return out

    def _fold(self, node, ctx: tuple, combine) -> _Pat:
        ctx = self._context(node, ctx)
        pats = [self._pattern(c, ctx) for c in self._rng_children(node)]
        if not pats:
            self._refuse(node)
        out = pats[0]
        for p in pats[1:]:
            out = combine(out, p)
        return out

    def _pattern(self, node, ctx: tuple) -> _Pat:
        kind = _local_name(node.tag)
        if kind not in _SUPPORTED or kind in ("grammar", "start", "define"):
            self._refuse(node)
        ctx = self._context(node, ctx)
        if kind == "element":
            element = _Element(self._name(node, ctx[0]),
                               lambda: self._group(node, ctx))
            self._elements.append(element)
            return element
        if kind == "attribute":
            name = self._name(node, "")
            content = self._group(node, ctx) if self._rng_children(node) \
                else self.text
            return self.attribute(name, content)
        if kind == "group":
            return self._group(node, ctx)
        if kind == "choice":
            return self._fold(node, ctx, self.choice)
        if kind == "interleave":
            return self._fold(node, ctx, self.interleave)
        if kind == "optional":
            return self.choice(self._group(node, ctx), self.empty)
        if kind == "zeroOrMore":
            return self.choice(self.one_or_more(self._group(node, ctx)),
                               self.empty)
        if kind == "oneOrMore":
            return self.one_or_more(self._group(node, ctx))
        if kind == "ref":
            return self._ref(node)
        if kind == "text":
            return self.text
        if kind == "empty":
            return self.empty
        if self._rng_children(node) or (kind == "data" and len(node)):
            self._refuse(next(iter(node)))
        if kind == "value":
            lib, dtype = ctx[1], node.get("type")
            if dtype is None:
                lib, dtype = "", "token"
            return self._intern(_VALUE, self._datatype(node, lib, dtype),
                                node.text or "")
        return self._intern(_DATA, self._datatype(node, ctx[1],
                                                  node.get("type")))

    def _datatype(self, node, lib: str, dtype: str) -> str:
        if (lib == "" and dtype in ("token", "string")) or \
                (lib == _XSD_LIB and dtype in _XSD_TYPES):
            return dtype
        raise IllegalOperation(
            f"RELAX NG datatype '{dtype}' of library '{lib}' ({self.path}:"
            f"{node.sourceline}) is not supported by this validator")

    def _name(self, node, ns: str) -> tuple:
        name = node.get("name")
        if name is None:
            raise IllegalOperation(
                f"RELAX NG name classes ({self.path}:{node.sourceline}) are "
                "not supported by this validator: give a name attribute")
        if ":" in name:
            raise IllegalOperation(
                f"RELAX NG qualified name '{name}' ({self.path}:"
                f"{node.sourceline}) is not supported by this validator")
        return (ns, name)

    def _ref(self, node) -> _Pat:
        return self._ref_named(node.get("name"), node)

    def _ref_named(self, name: str, node) -> _Pat:
        if name not in self._defines:
            raise XmlParseError(f"Invalid RELAX NG schema: reference to "
                                f"undefined pattern '{name}'",
                                filename=self.path, line=node.sourceline)
        if name not in self._define_pats:
            self._define_pats[name] = None      # Recursion guard.
            self._define_pats[name] = self._group(self._defines[name],
                                                  self._root_ctx)
        pat = self._define_pats[name]
        if pat is None:
            raise IllegalOperation(
                f"RELAX NG define '{name}' ({self.path}) refers to itself "
                "outside an element")
        return pat

    # -- pattern constructors (interned, simplified) -----------------------
    def _intern(self, kind, a=None, b=None, nullable=False) -> _Pat:
        key = (kind, id(a) if isinstance(a, _Pat) else a,
               id(b) if isinstance(b, _Pat) else b)
        pat = self._interned.get(key)
        if pat is None:
            pat = self._interned[key] = _Pat(kind, a, b, nullable)
        return pat

    def choice(self, a: _Pat, b: _Pat) -> _Pat:
        if a is self.not_allowed or a is b:
            return b
        if b is self.not_allowed:
            return a
        # Canonical order and no repeats, so equal choices intern alike.
        alts = sorted({id(p): p for p in self._alternatives(a) +
                       self._alternatives(b)}.items())
        out = alts[0][1]
        for _key, p in alts[1:]:
            out = self._intern(_CHOICE, out, p,
                               out.nullable or p.nullable)
        return out

    def _alternatives(self, p: _Pat) -> list:
        if p.kind == _CHOICE:
            return self._alternatives(p.a) + self._alternatives(p.b)
        return [p]

    def group(self, a: _Pat, b: _Pat) -> _Pat:
        if a is self.not_allowed or b is self.not_allowed:
            return self.not_allowed
        if a is self.empty:
            return b
        if b is self.empty:
            return a
        return self._intern(_GROUP, a, b, a.nullable and b.nullable)

    def interleave(self, a: _Pat, b: _Pat) -> _Pat:
        if a is self.not_allowed or b is self.not_allowed:
            return self.not_allowed
        if a is self.empty:
            return b
        if b is self.empty:
            return a
        return self._intern(_INTERLEAVE, a, b, a.nullable and b.nullable)

    def after(self, a: _Pat, b: _Pat) -> _Pat:
        if a is self.not_allowed or b is self.not_allowed:
            return self.not_allowed
        return self._intern(_AFTER, a, b)

    def one_or_more(self, p: _Pat) -> _Pat:
        if p is self.not_allowed:
            return p
        return self._intern(_ONE_OR_MORE, p, None, p.nullable)

    def attribute(self, name: tuple, content: _Pat) -> _Pat:
        return self._intern(_ATTRIBUTE, name, content)

    # -- derivatives ------------------------------------------------------
    def _memoized(self, tag, p: _Pat, arg, compute) -> _Pat:
        key = (tag, id(p), arg)
        out = self._memo.get(key)
        if out is None:
            out = self._memo[key] = compute()
        return out

    def apply_after(self, f, p: _Pat) -> _Pat:
        """``p`` with ``f`` applied to the follow part of each ``after``
        (``f`` = ``(kind, other)``: combine as ``kind(x, other)`` or, for
        a negative kind, ``kind(other, x)``)."""
        if p.kind == _AFTER:
            return self.after(p.a, self._apply(f, p.b))
        if p.kind == _CHOICE:
            return self.choice(self.apply_after(f, p.a),
                               self.apply_after(f, p.b))
        return self.not_allowed

    def _apply(self, f, x: _Pat) -> _Pat:
        kind, other = f
        if kind == "group":
            return self.group(x, other)
        if kind == "interleave-left":
            return self.interleave(x, other)
        if kind == "interleave-right":
            return self.interleave(other, x)
        return self.after(x, other)

    def start_tag_open(self, p: _Pat, qn: tuple) -> _Pat:
        return self._memoized("open", p, qn,
                              lambda: self._start_tag_open(p, qn))

    def _start_tag_open(self, p: _Pat, qn: tuple) -> _Pat:
        k = p.kind
        if k == _CHOICE:
            return self.choice(self.start_tag_open(p.a, qn),
                               self.start_tag_open(p.b, qn))
        if k == _ELEMENT:
            return self.after(p.content, self.empty) if p.a == qn \
                else self.not_allowed
        if k == _INTERLEAVE:
            return self.choice(
                self.apply_after(("interleave-left", p.b),
                                 self.start_tag_open(p.a, qn)),
                self.apply_after(("interleave-right", p.a),
                                 self.start_tag_open(p.b, qn)))
        if k == _ONE_OR_MORE:
            return self.apply_after(
                ("group", self.choice(p, self.empty)),
                self.start_tag_open(p.a, qn))
        if k == _GROUP:
            x = self.apply_after(("group", p.b),
                                 self.start_tag_open(p.a, qn))
            return self.choice(x, self.start_tag_open(p.b, qn)) \
                if p.a.nullable else x
        if k == _AFTER:
            return self.apply_after(("after", p.b),
                                    self.start_tag_open(p.a, qn))
        return self.not_allowed

    def att_deriv(self, p: _Pat, qn: tuple, value: str) -> _Pat:
        k = p.kind
        if k == _AFTER:
            return self.after(self.att_deriv(p.a, qn, value), p.b)
        if k == _CHOICE:
            return self.choice(self.att_deriv(p.a, qn, value),
                               self.att_deriv(p.b, qn, value))
        if k == _GROUP:
            return self.choice(self.group(self.att_deriv(p.a, qn, value),
                                          p.b),
                               self.group(p.a,
                                          self.att_deriv(p.b, qn, value)))
        if k == _INTERLEAVE:
            return self.choice(
                self.interleave(self.att_deriv(p.a, qn, value), p.b),
                self.interleave(p.a, self.att_deriv(p.b, qn, value)))
        if k == _ONE_OR_MORE:
            return self.group(self.att_deriv(p.a, qn, value),
                              self.choice(p, self.empty))
        if k == _ATTRIBUTE:
            return self.empty if p.a == qn and self.value_match(p.b, value) \
                else self.not_allowed
        return self.not_allowed

    def value_match(self, p: _Pat, s: str) -> bool:
        return (p.nullable and not s.strip(_XML_SPACE)) or \
            self.text_deriv(p, s).nullable

    def start_tag_close(self, p: _Pat) -> _Pat:
        return self._memoized("close", p, None,
                              lambda: self._start_tag_close(p))

    def _start_tag_close(self, p: _Pat) -> _Pat:
        k = p.kind
        if k == _AFTER:
            return self.after(self.start_tag_close(p.a), p.b)
        if k == _CHOICE:
            return self.choice(self.start_tag_close(p.a),
                               self.start_tag_close(p.b))
        if k == _GROUP:
            return self.group(self.start_tag_close(p.a),
                              self.start_tag_close(p.b))
        if k == _INTERLEAVE:
            return self.interleave(self.start_tag_close(p.a),
                                   self.start_tag_close(p.b))
        if k == _ONE_OR_MORE:
            return self.one_or_more(self.start_tag_close(p.a))
        if k == _ATTRIBUTE:
            return self.not_allowed
        return p

    def text_deriv(self, p: _Pat, s: str) -> _Pat:
        k = p.kind
        if k == _CHOICE:
            return self.choice(self.text_deriv(p.a, s),
                               self.text_deriv(p.b, s))
        if k == _INTERLEAVE:
            return self.choice(self.interleave(self.text_deriv(p.a, s), p.b),
                               self.interleave(p.a, self.text_deriv(p.b, s)))
        if k == _GROUP:
            x = self.group(self.text_deriv(p.a, s), p.b)
            return self.choice(x, self.text_deriv(p.b, s)) \
                if p.a.nullable else x
        if k == _AFTER:
            return self.after(self.text_deriv(p.a, s), p.b)
        if k == _ONE_OR_MORE:
            return self.group(self.text_deriv(p.a, s),
                              self.choice(p, self.empty))
        if k == _TEXT:
            return p
        if k == _VALUE:
            return self.empty if _datatype_equal(p.a, p.b, s) \
                else self.not_allowed
        if k == _DATA:
            return self.empty if _datatype_allows(p.a, s) \
                else self.not_allowed
        return self.not_allowed

    def end_tag(self, p: _Pat) -> _Pat:
        return self._memoized("end", p, None, lambda: self._end_tag(p))

    def _end_tag(self, p: _Pat) -> _Pat:
        if p.kind == _CHOICE:
            return self.choice(self.end_tag(p.a), self.end_tag(p.b))
        if p.kind == _AFTER:
            return p.b if p.a.nullable else self.not_allowed
        return self.not_allowed

    # -- what a pattern would take (for messages) --------------------------
    def expected(self, p: _Pat, kind: str, seen=None) -> list:
        """The element names (``kind`` = element) or attribute patterns
        (``kind`` = attribute) that ``p`` could take next."""
        seen = set() if seen is None else seen
        if id(p) in seen:
            return []
        seen.add(id(p))
        if p.kind == kind:
            return [p]
        if p.kind in (_CHOICE, _INTERLEAVE):
            return self.expected(p.a, kind, seen) + \
                self.expected(p.b, kind, seen)
        if p.kind == _GROUP:
            out = self.expected(p.a, kind, seen)
            return out + self.expected(p.b, kind, seen) \
                if p.a.nullable or kind == _ATTRIBUTE else out
        if p.kind in (_AFTER, _ONE_OR_MORE):
            return self.expected(p.a, kind, seen)
        return []


def _datatype_allows(dtype: str, s: str) -> bool:
    if dtype in ("token", "string"):
        return True
    return bool(_XSD_TYPES[dtype].match(_collapse(s)))


def _datatype_equal(dtype: str, want: str, s: str) -> bool:
    if dtype == "string":
        return want == s
    if dtype == "token":
        return _collapse(want) == _collapse(s)
    return _datatype_allows(dtype, s) and _collapse(want) == _collapse(s)


def _describe(grammar: _Grammar, content: _Pat) -> str:
    """An attribute's value pattern in words."""
    alts = grammar._alternatives(content)
    if all(a.kind == _VALUE for a in alts):
        return "one of " + ", ".join(sorted(a.b for a in alts))
    if len(alts) == 1 and alts[0].kind == _DATA:
        return alts[0].a
    return "allowed"


class _Invalid(Exception):
    """The first place the document leaves the grammar."""

    def __init__(self, message: str, line: int):
        super().__init__(message)
        self.line = line


def _qname(tag: str) -> tuple:
    return (tag[1:].partition("}")[0], tag.rpartition("}")[2]) \
        if tag.startswith("{") else ("", tag)


class Validator:
    """A RELAX NG grammar (``schema_path``) that validates documents.

    The standard library has no RELAX NG engine, so the grammar is
    interpreted here with Clark's derivative algorithm over the parsed
    document (patterns interned, derivatives memoized).  It takes the
    constructs of the bundled grammars: ``grammar``, ``start``,
    ``define``, ``ref``, ``element``, ``attribute``, ``group``,
    ``choice``, ``interleave``, ``optional``, ``zeroOrMore``,
    ``oneOrMore``, ``text``, ``empty``, ``value`` and ``data`` (xsd
    ``boolean``, ``double``, ``integer``, ``nonNegativeInteger``,
    ``positiveInteger``, in libxml2's lexical forms); any other construct
    raises :class:`IllegalOperation`.

    Verdicts are RELAX NG's (lxml's).  An error names the line of the
    first node, in document order, that the grammar refuses: an element
    (its name, an attribute or a missing one, or its missing content) or
    a text run.  lxml's error log names that line too (beside the lines
    of the ancestors it reports after it).
    """

    def __init__(self, schema_path: str):
        if not os.path.isfile(schema_path):
            raise IllegalOperation(f"RELAX NG schema '{schema_path}' is not "
                                   "a file")
        self._grammar = _Grammar(schema_path)

    def validate(self, document: "Document") -> None:
        """Raise :class:`ValidityError` (file and line) where the
        document breaks the grammar."""
        g = self._grammar
        root = document._root
        try:
            if not self._child(g.start, root).nullable:
                raise _Invalid("Document failed RELAX NG validation",
                               root.sourceline)
        except _Invalid as exc:
            raise ValidityError(str(exc), filename=document._label,
                                line=exc.line) from None

    def _child(self, p: _Pat, node) -> _Pat:
        """The derivative of ``p`` by element ``node`` (Clark's
        ``childDeriv``), raising :class:`_Invalid` where it fails."""
        g = self._grammar
        name = _local_name(node.tag)
        qn = _qname(node.tag)
        p1 = g.start_tag_open(p, qn)
        if p1 is g.not_allowed:
            want = sorted({e.a[1] for e in g.expected(p, _ELEMENT)})
            raise _Invalid(f"Did not expect element {name} there"
                           + (f" (expecting {', '.join(want)})"
                              if want else ""), node.sourceline)
        for att, value in node.attrib.items():
            p2 = g.att_deriv(p1, _qname(att), value)
            if p2 is g.not_allowed:
                att_name = _local_name(att)
                matches = [a for a in g.expected(p1, _ATTRIBUTE)
                           if a.a == _qname(att)]
                if matches:
                    raise _Invalid(
                        f"Value {value!r} of attribute {att_name} of "
                        f"element {name} is not "
                        f"{_describe(g, matches[0].b)}", node.sourceline)
                raise _Invalid(f"Invalid attribute {att_name} for element "
                               f"{name}", node.sourceline)
            p1 = p2
        p3 = g.start_tag_close(p1)
        if p3 is g.not_allowed:
            missing = sorted({a.a[1] for a in g.expected(p1, _ATTRIBUTE)
                              if not a.nullable})
            raise _Invalid(f"Element {name} failed to validate attributes"
                           + (f" (lacks {', '.join(missing)})"
                              if missing else ""), node.sourceline)
        p4 = self._children(p3, node)
        p5 = g.end_tag(p4)
        if p5 is g.not_allowed:
            want = sorted({e.a[1] for e in g.expected(p4, _ELEMENT)})
            raise _Invalid(f"Element {name}: expecting an element "
                           f"{' or '.join(want) if want else ''}, got "
                           f"nothing", node.sourceline)
        return p5

    def _children(self, p: _Pat, node) -> _Pat:
        """Clark's ``childrenDeriv`` over the element's text and child
        elements (whitespace-only text ignored beside elements).  A text
        run that fails reports its element's line, as libxml2 does."""
        g = self._grammar
        if not len(node) and not (node.text or "").strip(_XML_SPACE):
            return g.choice(p, g.text_deriv(p, node.text or ""))
        p = self._text(p, node, node.text)
        for child in node:
            p = self._text(self._child(p, child), node, child.tail)
        return p

    def _text(self, p: _Pat, node, text: str | None) -> _Pat:
        """``p`` after one text run of ``node`` (skipped when blank)."""
        if not text or not text.strip(_XML_SPACE):
            return p
        p = self._grammar.text_deriv(p, text)
        if p is self._grammar.not_allowed:
            raise _Invalid(f"Element {_local_name(node.tag)} has unexpected "
                           f"text {text.strip(_XML_SPACE)!r}",
                           node.sourceline)
        return p


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
