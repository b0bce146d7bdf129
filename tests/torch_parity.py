"""Shared helpers of the torch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on its CPU backend (its Pallas kernels in interpret
mode), the port on the CPU through its kernels' plain versions.
"""

import os

import pytest
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

#: Fixtures whose fault trees quantify through the exact-BDD path.
FAULT_TREE_FIXTURES = [
    "aralia_like_small", "aralia_like_medium", "aralia_like_large",
    "aralia_like_ccf", "aralia_like_noncoherent",
    "aralia_like_nested_count", "aralia_like_substitution",
    "brute_noncoherent"]
ALL_FIXTURES = sorted(f[:-4] for f in os.listdir(FIXTURES)
                      if f.endswith(".xml"))


def fixture_path(name: str) -> str:
    return os.path.join(FIXTURES, f"{name}.xml")


def load_tree(pkg: str, name: str, ccf: bool = True,
              tree_name: str | None = None):
    """(model, compiled tree) of fixture ``name``'s fault tree
    ``tree_name`` (default: the fixture's name) from either package
    (``"canopy_tpu"`` or ``"canopy_tpu_torch"``)."""
    import importlib
    mef = importlib.import_module(f"{pkg}.mef")
    settings_mod = importlib.import_module(f"{pkg}.settings")
    graph = importlib.import_module(f"{pkg}.compiler.graph")
    settings = settings_mod.Settings().ccf_analysis(ccf)
    model = mef.Initializer([fixture_path(name)], settings).model
    fault_tree = model.fault_trees.get(tree_name or name)
    return model, graph.compile_fault_tree(fault_tree)


def overwriting_program(stream_program_cls):
    """A hand-written stream program whose ops write the very pool slot
    one of their own arguments reads (the linear-scan allocator allows
    it), with a spill, a count gate, a pair, an inverted product, a fill
    and a mux.  ``stream_program_cls`` is either package's
    ``StreamProgram``."""
    import numpy as np
    stage = lambda off: ("stage", 0, off)  # noqa: E731
    ops = [
        ("start", 0, 0), ("wait", 0, 0),
        ("spill", 0, 5, 3),
        ("gate", "prod", 0, [(stage(0), False), (stage(1), True)], False),
        ("gate", "count", 1, [(("pool", 0), False), (stage(2), False),
                              (stage(3), True), (("pool", 3), False)],
         (2, 3)),
        # out slot 0 == argument slot 0:
        ("gate", "pair", 0, [(("pool", 0), False), (("pool", 1), True)],
         False),
        # out slot 1 == argument slot 1, inverted product:
        ("gate", "prod", 1, [(("pool", 1), False), (("pool", 0), True),
                             (stage(4), False)], True),
        ("gate", "fill", 2, [], 0.25),
        # out slot 0 == its lo argument:
        ("gate", "mux", 0, [(("pool", 3), False), (("pool", 1), False),
                            (("pool", 0), False)], None),
    ]
    return stream_program_cls(
        ops=ops, basic_perm=np.arange(6), n_basic=6, n_basic_pad=8,
        chunk_tiles=8, n_chunks=1, n_bufs=1, pool_slots=4, top_slot=0,
        nnz=15, n_house=0)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: kernel cases run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested here)")
    return torch.device("cuda")
