"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
and the bit-packed Boolean evaluation."""

from .bitpack import (pack_states, packed_top_probability,  # noqa: F401
                      propagate_packed, sample_states_packed)
