"""Native (C++) components, loaded through ctypes.

``load_bdd_library()`` compiles ``bdd.cpp`` on first use (g++ -O3) into a
per-user cache directory and memoizes the handle; everything degrades
gracefully to the pure-Python implementations when no compiler is
available.
"""

from .build import load_bdd_library, native_available  # noqa: F401
