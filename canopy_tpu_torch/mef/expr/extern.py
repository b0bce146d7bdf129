"""Extern (FFI) expressions: dynamically loaded native functions.

Capability parity with the reference extern layer
(``reference/src/mef/openpsa/expr/extern.h:30-220``): a shared
library is loaded from an MEF ``define-extern-library`` declaration with
optional name decoration and system-path search; ``define-extern-function``
binds a typed symbol (up to 5 parameters, int/double only — the reference
generates its 126 interface combinations from the same base-3 type encoding,
``initializer.cpp:1476-1523``); ``extern-function`` expressions marshal MEF
expression arguments into the native call.

The rebuild uses ``ctypes`` instead of ``boost::dll``. Extern expressions
are host-evaluated: they cannot be traced into the TPU tape (the tape
compiler folds them to constants when their arguments are deterministic and
rejects deviate arguments with a clear error).
"""

from __future__ import annotations

import ctypes
import os

from ...errors import DLError, ValidityError
from ..element import Element, RoleSpecifier
from ..expression import Expression

_CTYPE = {"int": ctypes.c_int, "double": ctypes.c_double}

#: Maximum number of parameters for extern functions (reference extern.h).
MAX_PARAMS = 5


class ExternLibrary(Element):
    """A dynamically loaded shared library (reference ``extern.h:30-100``)."""

    kind = "extern library"

    def __init__(self, name: str, lib_path: str, reference_dir: str = "",
                 system: bool = False, decorate: bool = False,
                 base_path: str = "", role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        self.lib_path = lib_path
        if not lib_path:
            raise ValidityError("The library path cannot be empty.",
                                element=name, element_type=self.kind)
        if decorate:
            directory, fname = os.path.split(lib_path)
            if not fname.startswith("lib"):
                fname = "lib" + fname
            if "." not in fname:
                fname += ".so"
            lib_path = os.path.join(directory, fname)
        if not system and reference_dir:
            lib_path = os.path.join(reference_dir, lib_path)
        try:
            self._handle = ctypes.CDLL(lib_path)
        except OSError as exc:
            raise DLError(f"Cannot load extern library '{lib_path}': {exc}",
                          element=name, element_type=self.kind) from exc

    def get(self, symbol: str):
        try:
            return getattr(self._handle, symbol)
        except AttributeError as exc:
            raise DLError(f"Undefined symbol '{symbol}' in library "
                          f"'{self.lib_path}'.") from exc


class ExternFunction(Element):
    """A typed native function symbol (reference ``extern.h:120-180``)."""

    kind = "extern function"

    def __init__(self, name: str, symbol: str, library: ExternLibrary,
                 return_type: str, param_types: list[str],
                 base_path: str = "", role: RoleSpecifier = RoleSpecifier.PUBLIC):
        super().__init__(name, base_path, role)
        if len(param_types) > MAX_PARAMS:
            raise ValidityError(
                f"Extern functions support at most {MAX_PARAMS} parameters; "
                f"'{name}' declares {len(param_types)}.",
                element=name, element_type=self.kind)
        for type_name in [return_type, *param_types]:
            if type_name not in _CTYPE:
                raise ValidityError(
                    f"Unsupported extern function type '{type_name}' "
                    "(only 'int' and 'double').",
                    element=name, element_type=self.kind)
        self.symbol = symbol
        self.return_type = return_type
        self.param_types = list(param_types)
        self._fn = library.get(symbol)
        self._fn.restype = _CTYPE[return_type]
        self._fn.argtypes = [_CTYPE[t] for t in param_types]

    def __call__(self, *values: float) -> float:
        coerced = [int(v) if t == "int" else float(v)
                   for v, t in zip(values, self.param_types)]
        return float(self._fn(*coerced))

    def apply(self, args: list[Expression]) -> "ExternExpression":
        if len(args) != len(self.param_types):
            raise ValidityError(
                f"Extern function '{self.name}' expects "
                f"{len(self.param_types)} arguments, got {len(args)}.")
        return ExternExpression(self, args)


class ExternExpression(Expression):
    """Marshals expression arguments into an extern function call."""

    tape_op = "extern"

    def __init__(self, function: ExternFunction, args: list[Expression]):
        super().__init__(args)
        self.function = function

    def _compute(self, *values: float) -> float:
        return self.function(*values)
