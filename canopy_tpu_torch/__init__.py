"""canopy-tpu-torch: the exact-BDD quantification path on PyTorch and CUDA.

A second package beside ``canopy_tpu``: the same Open-PSA MEF front end
(vendored copies of the numpy-only host layers — the JAX package's
``__init__`` imports jax, which the GPU machine does not have), and the
exact-BDD main path (probability, products, importance, uncertainty) on
PyTorch, with the stream and adjoint kernels written by hand in CUDA C++
for Hopper (``csrc/``).

Dtypes are explicit everywhere (f64 for the host-side and point-estimate
math, f32 in the kernels), and so is the device: nothing on the path picks
CUDA when available or falls back to the CPU on its own.
"""

__version__ = "0.3.0"


def build_info() -> dict:
    """Git-derived build metadata (commit, count, dirty) — the
    reference's ``cmake/build-info.cmake`` analogue; see
    :mod:`canopy_tpu_torch.build_info`."""
    from .build_info import build_info as _bi
    return _bi()


from .settings import Algorithm, Approximation, Settings  # noqa: F401,E402
from . import errors  # noqa: F401,E402
