"""Lazy build + load of the native BDD library."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

_SOURCE = os.path.join(os.path.dirname(__file__), "bdd.cpp")
_handle = None
_tried = False


def _cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    path = os.path.join(base, "canopy_tpu_torch")
    os.makedirs(path, exist_ok=True)
    return path


def _build() -> str | None:
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    lib_path = os.path.join(_cache_dir(), f"libcanopy_bdd_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    with tempfile.TemporaryDirectory() as tmp:
        tmp_lib = os.path.join(tmp, "libcanopy_bdd.so")
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SOURCE,
               "-o", tmp_lib]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as exc:
            print(f"canopy_tpu_torch: native BDD build failed ({exc}); "
                  "falling back to pure Python.", file=sys.stderr)
            return None
        os.replace(tmp_lib, lib_path)
    return lib_path


def load_bdd_library():
    """The ctypes handle to the native BDD library, or None."""
    global _handle, _tried
    if _tried:
        return _handle
    _tried = True
    lib_path = _build()
    if lib_path is None:
        return None
    lib = ctypes.CDLL(lib_path)
    lib.canopy_bdd_new.restype = ctypes.c_void_p
    lib.canopy_bdd_new.argtypes = [ctypes.c_int32, ctypes.c_int64]
    lib.canopy_bdd_free.argtypes = [ctypes.c_void_p]
    for name in ("var", "not"):
        fn = getattr(lib, f"canopy_bdd_{name}")
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("and", "or", "xor"):
        fn = getattr(lib, f"canopy_bdd_{name}")
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.canopy_bdd_ite.restype = ctypes.c_int32
    lib.canopy_bdd_ite.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32]
    lib.canopy_bdd_atleast.restype = ctypes.c_int32
    lib.canopy_bdd_atleast.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.canopy_bdd_n_nodes.restype = ctypes.c_int64
    lib.canopy_bdd_n_nodes.argtypes = [ctypes.c_void_p]
    lib.canopy_bdd_overflow.restype = ctypes.c_int32
    lib.canopy_bdd_overflow.argtypes = [ctypes.c_void_p]
    lib.canopy_bdd_export.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.canopy_minsol.restype = ctypes.c_void_p
    lib.canopy_minsol.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
    for name, restype in (("count", ctypes.c_int64),
                          ("total", ctypes.c_int64),
                          ("truncated", ctypes.c_int32),
                          ("overflow", ctypes.c_int32),
                          ("zdd_nodes", ctypes.c_int64)):
        fn = getattr(lib, f"canopy_minsol_{name}")
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]
    lib.canopy_minsol_export.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.canopy_minsol_free.argtypes = [ctypes.c_void_p]
    _handle = lib
    return _handle


def native_available() -> bool:
    return load_bdd_library() is not None
