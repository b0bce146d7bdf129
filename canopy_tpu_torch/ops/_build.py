"""Build and load the CUDA kernels of ``csrc/`` (nvcc, plain C ABI, ctypes).

The library is compiled at first use, from the package's own sources,
into ``canopy_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the sources and the flags, so an edited kernel rebuilds and an
unchanged one loads in milliseconds.  Each source compiles in its own
``nvcc`` process, all started together, and one more links them (a
build's time is its slowest source's, not their sum).  ``--fmad=false``
keeps every multiply and add rounded on its own, as in the plain PyTorch
versions, so kernel and plain agree bit for bit.  Every launcher shares
the ABI's plumbing here: :func:`_ptr` (a tensor's pointer, null for None)
and :func:`_raise_on` (a launcher's CUDA error code as an exception).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from ..utils.profiling import COUNTERS, span

__all__ = ["load_library", "build_info", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SOURCES = ("stream.cu", "adjoint.cu", "fused.cu", "replay.cu",
            "replay_adjoint.cu", "spill.cu", "bernoulli.cu", "gather.cu",
            "block_gather.cu", "prng.cu")
_HEADERS = ("stream_ops.cuh", "adjoint_ops.cuh", "replay_ops.cuh")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, f"libcanopy_stream_{_digest()}.so")
    _info.update(path=lib_path, built=False, seconds=0.0, ptxas="")
    if os.path.exists(lib_path):
        return lib_path
    COUNTERS["builds"] += 1
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with span("build"), tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objects, procs = [], []
        for name in _SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                   os.path.join(_CSRC, name)]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        reports = []
        for name, (cmd, proc) in zip(_SOURCES, procs):
            _out, err = proc.communicate()
            if proc.returncode != 0:
                for _c, other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            reports.append(f"nvcc: {name}\n{err}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o",
                tmp_lib, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    _info.update(built=True, seconds=time.perf_counter() - t0,
                 cmd="\n".join(" ".join(c) for c in
                                [*(cmd for cmd, _p in procs), link]),
                 ptxas="".join(reports))
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' ctypes handle (built on first call; raises on a
    failed build — there is no fallback)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for suffix in ("f32", "f64"):
        fwd = getattr(lib, f"canopy_stream_forward_{suffix}")
        fwd.argtypes = [vp, vp, i32, vp, vp, vp, vp, vp, vp, i64, vp, i64,
                        i32, vp]
        fwd.restype = i32
        fwd = getattr(lib, f"canopy_stream_ops_forward_{suffix}")
        fwd.argtypes = [vp, vp, vp, i32, vp, vp, vp, vp, i64, vp, i32, vp,
                        vp]
        fwd.restype = i32
        lvl = getattr(lib, f"canopy_stream_level_forward_{suffix}")
        lvl.argtypes = [vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, i64, i32,
                        i32, i32, i32, i32, vp, vp]
        lvl.restype = i32
        lvl = getattr(lib, f"canopy_stream_level_backward_{suffix}")
        lvl.argtypes = [vp, vp, vp, vp, i32, vp, vp, vp, vp, i32, vp, vp,
                        vp, vp, vp, vp, i64, i32, i32, i32, i32, vp, vp]
        lvl.restype = i32
        for name in ("replay_forward", "replay_tape_forward"):
            fwd = getattr(lib, f"canopy_{name}_{suffix}")
            fwd.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp, vp, i64, i32,
                            i32, i32, i32, i32, vp, vp]
            fwd.restype = i32
        fwd = getattr(lib, f"canopy_spill_forward_{suffix}")
        fwd.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp, i64, i32, i32, i32,
                        i32, vp, vp]
        fwd.restype = i32
    lib.canopy_fused_forward_f32.argtypes = [vp, i32, i32, vp, vp, vp, vp,
                                             vp, i64, i32, i32, i32, i32, vp,
                                             vp]
    lib.canopy_fused_forward_f32.restype = i32
    lib.canopy_fused_max_smem_bytes.restype = i32
    lib.canopy_fused_blocks_per_sm.argtypes = [i32]
    lib.canopy_fused_blocks_per_sm.restype = i32
    lib.canopy_packed_bernoulli.argtypes = [vp, i64, i64, i64, ctypes.c_uint,
                                            ctypes.c_uint, vp, vp]
    lib.canopy_packed_bernoulli.restype = i32
    lib.canopy_gather_level.argtypes = [vp, i64, vp, vp, vp, vp, vp, i32,
                                        i32, vp]
    lib.canopy_gather_level.restype = i32
    lib.canopy_block_gather_level.argtypes = [vp, i64, vp, vp, vp, vp, vp,
                                              *[i32] * 9, vp]
    lib.canopy_block_gather_level.restype = i32
    lib.canopy_prng_draw_standard.argtypes = [vp, vp, i32, i64, i32, vp,
                                              vp]
    lib.canopy_prng_draw_standard.restype = i32
    lib.canopy_prng_draw_gamma.argtypes = [vp, i64, vp, i64, i32, vp, vp]
    lib.canopy_prng_draw_gamma.restype = i32
    lib.canopy_cuda_error_string.argtypes = [i32]
    lib.canopy_cuda_error_string.restype = ctypes.c_char_p
    lib.canopy_max_count_states.restype = i32
    lib.canopy_stream_rec_chunk.restype = i32
    _lib = lib
    return _lib


def _raise_on(lib, code: int, what: str) -> None:
    """Raise on a launcher's nonzero CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.canopy_cuda_error_string(code).decode()}")


def _ptr(tensor) -> int:
    """A tensor's device pointer, 0 (null) for None."""
    return 0 if tensor is None else tensor.data_ptr()


def build_info() -> dict:
    """Library path, whether this process compiled it, the seconds the
    build took, its nvcc commands (one per line) and nvcc's ptxas report
    (registers, spills; each source's part after a line ``nvcc:
    <source>``)."""
    return dict(_info)
