"""Torch port, the BSR log-space engine against the JAX package's.

* ``compile_bsr`` builds the same tiles, pair lists and output flags as
  the JAX package's (every array equal), ``estimate_bsr_fill`` and
  ``bsr_cost_report`` the same numbers, on a random-structure tree, a
  local one and a reordered hierarchical one.
* ``bsr_top_probability`` (torch: block gather, float32 einsum,
  ``index_add_``) is within 1e-6 relative of the JAX package's on the
  same numpy inputs, whole and in ``t_chunk`` slabs, per trial plus 1e-6
  of the largest top: both are float32 log/exp round trips summed in
  different orders, and a log sum ``y`` rounds to about ``2^-24 |y|``
  per level, so a small top (``|y|`` near 10) carries a few 1e-6.
* Hard 0/1 inputs are exact: equal to the port's float32 gather engine.
* Count gates are refused with ``LogicError``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from canopy_tpu.compiler.reorder import locality_reorder as jax_reorder
from canopy_tpu.compiler.reorder import random_shuffle as jax_shuffle
from canopy_tpu.ops import bsr_propagate as jbsr
from canopy_tpu.utils import synthetic as jax_synthetic
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.compiler.reorder import locality_reorder, random_shuffle
from canopy_tpu_torch.engine.propagate import top_event_probability
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import bsr_propagate as tbsr
from canopy_tpu_torch.utils import synthetic

TREES = {
    "random": dict(n_basic=512, n_gates=1000, fanin=4, n_levels=6, seed=1),
    "local": dict(n_basic=512, n_gates=1000, fanin=4, n_levels=6, seed=1,
                  locality=256),
}
HIER = dict(n_basic=1024, branching=8, share_fraction=0.1, n_shared=128,
            seed=0)


def trees(name):
    """(JAX tree, port tree) of case ``name``."""
    if name == "hier":
        return (jax_reorder(jax_shuffle(
                    jax_synthetic.synthetic_hierarchical_tree(**HIER),
                    seed=1).tree, method="auto").tree,
                locality_reorder(random_shuffle(
                    synthetic.synthetic_hierarchical_tree(**HIER),
                    seed=1).tree, method="auto").tree)
    return (jax_synthetic.synthetic_compiled_tree(**TREES[name]),
            synthetic.synthetic_compiled_tree(**TREES[name]))


@pytest.mark.parametrize("name", ["random", "local", "hier"])
def test_compile_bsr_matches(name):
    jt, tt = trees(name)
    jp, tp = jbsr.compile_bsr(jt), tbsr.compile_bsr(tt)
    for field in ("n_nodes", "n_pad", "n_basic", "n_house", "top_index",
                  "nnz", "fill_blocks", "row_block"):
        assert getattr(jp, field) == getattr(tp, field), field
    assert len(jp.levels) == len(tp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        for field, value in vars(jl).items():
            other = getattr(tl, field)
            assert np.shape(value) == np.shape(other), field
            assert np.array_equal(value, other), field
    assert jbsr.estimate_bsr_fill(jt) == tbsr.estimate_bsr_fill(tt)
    assert jbsr.bsr_cost_report(jp) == tbsr.bsr_cost_report(tp)


@pytest.mark.parametrize("name", ["random", "hier"])
def test_top_probability_matches_jax(name):
    jt, tt = trees(name)
    p = np.random.default_rng(0).uniform(0.0, 0.9, (128, tt.n_basic)) \
        .astype(np.float32)
    want = np.asarray(jbsr.bsr_top_probability(jbsr.compile_bsr(jt),
                                               jnp.asarray(p)))
    program = tbsr.compile_bsr(tt)
    for t_chunk in (32, 256):
        got = tbsr.bsr_top_probability(program, torch.from_numpy(p),
                                       t_chunk=t_chunk)
        assert got.dtype == torch.float32 and got.shape == (128,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_hard_zero_one_exact():
    _jt, tt = trees("local")
    states = (np.random.default_rng(1).random((64, tt.n_basic)) < 0.5) \
        .astype(np.float32)
    got = tbsr.bsr_top_probability(tbsr.compile_bsr(tt),
                                   torch.from_numpy(states))
    assert torch.equal(got, top_event_probability(
        tt, torch.from_numpy(states)))


def test_rejects_count_gates():
    top, _ = synthetic.synthetic_mef_tree(n_basic=32, n_gates=24,
                                          atleast_fraction=0.5, seed=1)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    with pytest.raises(LogicError):
        tbsr.compile_bsr(tree)
