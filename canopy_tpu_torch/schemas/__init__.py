"""The bundled RELAX NG grammars (the JAX package's copies): the MEF
input grammar, the report grammar and the project grammar.  The port
validates against them with its own interpreter (``io/xml.Validator``).
"""

import os

__all__ = ["default_schema_path", "report_schema_path",
           "project_schema_path"]


def default_schema_path() -> str:
    """The bundled MEF input grammar (analogue of env.h's input.rng)."""
    return os.path.join(os.path.dirname(__file__), "mef.rng")


def report_schema_path() -> str:
    """The bundled report grammar (analogue of env.h's report.rng)."""
    return os.path.join(os.path.dirname(__file__), "report.rng")


def project_schema_path() -> str:
    """The bundled project grammar (analogue of env.h's project.rng)."""
    return os.path.join(os.path.dirname(__file__), "project.rng")
