"""The bundled project grammar (``project.rng``, the JAX package's copy).

The port validates project files against it without a RELAX NG engine:
``io/xml.Validator`` checks this one grammar by hand.  The MEF and
report grammars are not bundled: their validation needs lxml.
"""

import os

__all__ = ["project_schema_path"]


def project_schema_path() -> str:
    """The bundled project grammar (analogue of env.h's project.rng)."""
    return os.path.join(os.path.dirname(__file__), "project.rng")
