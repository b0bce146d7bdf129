"""Typed error taxonomy for canopy-tpu.

Mirrors the capability of the reference error hierarchy
(``reference/src/mef/openpsa/error.h:23-96``) with Python idioms:
every model-level failure carries optional (file, line, element) context so
front-end errors always point back into the MEF XML source — restoring the
observability the reference stripped during its port (SURVEY.md §5).
"""

from __future__ import annotations


class Error(Exception):
    """Base class for all canopy-tpu errors.

    Carries optional XML source context (filename/line) and the offending
    element's name/type, appended to the message when present.
    """

    def __init__(self, msg: str = "", *, filename: str | None = None,
                 line: int | None = None, element: str | None = None,
                 element_type: str | None = None):
        self.msg = msg
        self.filename = filename
        self.line = line
        self.element = element
        self.element_type = element_type
        super().__init__(msg)

    def with_context(self, *, filename: str | None = None, line: int | None = None,
                     element: str | None = None, element_type: str | None = None):
        """Enrich the error with source context (first writer wins)."""
        if self.filename is None:
            self.filename = filename
        if self.line is None:
            self.line = line
        if self.element is None:
            self.element = element
        if self.element_type is None:
            self.element_type = element_type
        return self

    def __str__(self) -> str:  # pragma: no cover - formatting
        parts = [self.msg]
        if self.element is not None:
            kind = f" ({self.element_type})" if self.element_type else ""
            parts.append(f"[element: {self.element}{kind}]")
        if self.filename is not None or self.line is not None:
            loc = self.filename or "<input>"
            if self.line is not None:
                loc += f":{self.line}"
            parts.append(f"[at {loc}]")
        return " ".join(p for p in parts if p)


class IOError_(Error):
    """File-system level failures (missing/duplicate/unreadable input)."""


class DLError(Error):
    """Dynamic-library (extern function) loading failures."""


class LogicError(Error):
    """Internal pre-condition violations (bugs in the caller)."""


class IllegalOperation(Error):
    """An operation that is not allowed in the current configuration."""


class SettingsError(Error):
    """Invalid analysis settings (out-of-range or inconsistent)."""


class VersionError(Error):
    """Unsupported MEF schema version."""


class ValidityError(Error):
    """The model structure violates MEF validity rules."""


class DuplicateElementError(ValidityError):
    """An element with the same id is already defined."""

    def __init__(self, name: str = "", **kw):
        super().__init__(f"Duplicate element: {name}" if name else "Duplicate element",
                         **kw)


class UndefinedElement(ValidityError):
    """A referenced element is not defined anywhere in the model."""

    def __init__(self, name: str = "", kind: str = "element", **kw):
        super().__init__(f"Undefined {kind}: {name}" if name else f"Undefined {kind}",
                         **kw)


class CycleError(ValidityError):
    """A cycle was detected in a supposedly acyclic structure."""


class DomainError(ValidityError):
    """An expression value or sample domain is outside its allowed domain."""


# XML layer errors (reference: src/io/xml/error.h:11-57).
class XmlError(Error):
    """Base for XML ingestion errors."""


class XmlParseError(XmlError):
    """Malformed XML."""


class XmlValidityError(XmlError):
    """The document does not conform to the RELAX NG schema."""


class XIncludeError(XmlError):
    """XInclude resolution failure."""
