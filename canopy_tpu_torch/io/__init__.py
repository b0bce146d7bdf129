"""IO layer: strict MEF XML ingestion on the standard library."""

from .xml import Document, Element, Validator  # noqa: F401
