"""Element core: names, labels, attributes, roles, and keyed containers.

Capability parity with the reference element machinery
(``reference/src/mef/openpsa/element.h:32-707``): MEF elements carry a
validated name, an optional label, an ordered attribute map with container
inheritance, a public/private role with a base path, and a full-path identity
for private elements. :class:`Table` provides duplicate-detecting keyed
storage (the Pythonic replacement for the Boost multi-index tables).
"""

from __future__ import annotations

import enum
from typing import Generic, Iterator, TypeVar

from ..errors import DuplicateElementError, LogicError, UndefinedElement, ValidityError


class Attribute:
    """A name/value(/type) annotation attached to an element."""

    __slots__ = ("name", "value", "type")

    def __init__(self, name: str, value: str, type_: str = ""):
        if not name:
            raise ValidityError("Attribute name cannot be empty.")
        self.name = name
        self.value = value
        self.type = type_

    def __repr__(self) -> str:  # pragma: no cover
        return f"Attribute({self.name}={self.value!r})"


class RoleSpecifier(enum.Enum):
    """Element visibility within the model."""

    PUBLIC = "public"
    PRIVATE = "private"


def check_name(name: str, kind: str = "element") -> str:
    """Validate an MEF element name (non-empty, no '.')."""
    if not name:
        raise ValidityError(f"The {kind} name cannot be empty.")
    if "." in name:
        raise ValidityError(
            f"The {kind} name '{name}' cannot contain '.'")
    return name


def check_base_path(path: str) -> str:
    """Validate a reference base path ('container.subcontainer' form)."""
    if path:
        for part in path.split("."):
            check_name(part, "path segment")
    return path


class Element:
    """Base class of every named MEF construct.

    Provides name validation, label, ordered attributes with parent
    (container) inheritance, role/base-path, and identity: a public
    element's id is its name; a private element's id is
    ``base_path.name`` (reference ``element.h:325-380``).
    """

    #: Human-readable type string for error messages; overridden by subclasses.
    kind = "element"

    def __init__(self, name: str, base_path: str = "",
                 role: RoleSpecifier = RoleSpecifier.PUBLIC):
        self._name = check_name(name, self.kind)
        self._base_path = check_base_path(base_path)
        self._role = role
        self.label: str = ""
        self._attributes: dict[str, Attribute] = {}
        #: Containing element, for attribute inheritance.
        self.container: Element | None = None
        #: Whether this element is used anywhere in the model (element.h:694-707).
        self.usage: bool = False
        #: DFS mark for cycle detection / top-event collection (element.h:669-691).
        self.mark = None
        #: XML source context (filename, line) for error messages.
        self.source_location: tuple[str, int] | None = None

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def base_path(self) -> str:
        return self._base_path

    @property
    def role(self) -> RoleSpecifier:
        return self._role

    @property
    def id(self) -> str:
        """The lookup identity: full path for private, bare name for public."""
        if self._role is RoleSpecifier.PRIVATE and self._base_path:
            return f"{self._base_path}.{self._name}"
        return self._name

    @property
    def full_path(self) -> str:
        return f"{self._base_path}.{self._name}" if self._base_path else self._name

    # -- attributes --------------------------------------------------------
    def set_attribute(self, attribute: Attribute) -> None:
        if attribute.name in self._attributes:
            raise DuplicateElementError(
                f"attribute '{attribute.name}' on {self.kind} '{self.id}'")
        self._attributes[attribute.name] = attribute

    def get_attribute(self, name: str) -> Attribute | None:
        """Look up an attribute, inheriting from containers (element.h:32-56)."""
        attr = self._attributes.get(name)
        if attr is not None:
            return attr
        if self.container is not None:
            return self.container.get_attribute(name)
        return None

    def has_attribute(self, name: str) -> bool:
        return self.get_attribute(name) is not None

    def remove_attribute(self, name: str) -> Attribute:
        try:
            return self._attributes.pop(name)
        except KeyError:
            raise LogicError(
                f"No attribute '{name}' on {self.kind} '{self.id}'") from None

    @property
    def attributes(self) -> Iterator[Attribute]:
        return iter(self._attributes.values())

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.id!r}>"


T = TypeVar("T", bound=Element)


class Table(Generic[T]):
    """Keyed element storage with duplicate detection.

    The Pythonic stand-in for the reference ``ElementTable``/``IdTable``
    (Boost multi-index, ``element.h:388-462``) and the ``Container`` CRTP
    add/remove/get machinery (``element.h:470-571``). Iteration preserves
    insertion order; lookups are O(1).
    """

    def __init__(self, kind: str = "element", by_id: bool = True):
        self._kind = kind
        self._by_id = by_id
        self._data: dict[str, T] = {}

    def _key(self, element: T) -> str:
        return element.id if self._by_id else element.name

    def add(self, element: T) -> T:
        key = self._key(element)
        if key in self._data:
            raise DuplicateElementError(f"{self._kind}: {key}")
        self._data[key] = element
        return element

    def get(self, key: str) -> T:
        try:
            return self._data[key]
        except KeyError:
            raise UndefinedElement(key, self._kind) from None

    def find(self, key: str) -> T | None:
        return self._data.get(key)

    def remove(self, element: T) -> T:
        key = self._key(element)
        if key not in self._data or self._data[key] is not element:
            raise UndefinedElement(key, self._kind)
        return self._data.pop(key)

    def extract(self, key: str) -> T:
        """Move an element out of the table (reference multi_index.h:24-38)."""
        try:
            return self._data.pop(key)
        except KeyError:
            raise UndefinedElement(key, self._kind) from None

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[T]:
        return iter(self._data.values())

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()


class NodeMark(enum.Enum):
    """Three-color DFS mark (reference element.h:669-691)."""

    CLEAR = 0
    TEMPORARY = 1
    PERMANENT = 2
