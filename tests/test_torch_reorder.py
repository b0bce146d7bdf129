"""Torch port, the locality reorder pass against the JAX package's.

``canopy_tpu_torch/compiler/reorder.py`` is a vendored copy (drift-guarded
in ``tests/test_torch_host.py``); these tests hold what it builds in the
port's own compiled trees to what the JAX package builds, array for
array: ``random_shuffle``, ``locality_reorder`` under each method
(``first_use``, ``rcm`` and ``auto``, which ranks the two by the port's
``estimate_bsr_fill``) with and without ``hot_first``, and
``apply_permutation``, including its refusal of a cross-block move.
Tolerance: none, every array equal.
"""

import numpy as np
import pytest
import torch

from canopy_tpu.compiler.graph import compile_gates as jax_compile_gates
from canopy_tpu.compiler.reorder import apply_permutation as jax_apply
from canopy_tpu.compiler.reorder import locality_reorder as jax_reorder
from canopy_tpu.compiler.reorder import random_shuffle as jax_shuffle
from canopy_tpu.utils import synthetic as jax_synthetic
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.compiler.reorder import (apply_permutation,
                                               locality_reorder,
                                               random_shuffle)
from canopy_tpu_torch.engine.propagate import top_event_probability
from canopy_tpu_torch.utils import synthetic

HIER = dict(n_basic=1024, branching=8, share_fraction=0.1, n_shared=128,
            seed=0)


def assert_trees_equal(jt, tt):
    for field in ("n_basic", "n_house", "n_gates", "basic_index",
                  "house_index", "gate_index", "top_index"):
        assert getattr(jt, field) == getattr(tt, field), field
    assert len(jt.levels) == len(tt.levels)
    for jl, tl in zip(jt.levels, tt.levels):
        jb, tb = list(jl.iter_blocks()), list(tl.iter_blocks())
        assert [k for k, _ in jb] == [k for k, _ in tb]
        for (_k, x), (_k2, y) in zip(jb, tb):
            for field, value in vars(x).items():
                if field.startswith("_"):
                    continue
                other = getattr(y, field)
                assert np.shape(value) == np.shape(other), field
                assert np.array_equal(value, other), field
    assert [e.id for e in jt.basic_events] == [e.id for e in tt.basic_events]
    assert [g.id for g in jt.gates] == [g.id for g in tt.gates]


def mef_trees(**kw):
    """The same MEF tree compiled by both packages, top anchored."""
    out = []
    for mod, compile_fn in ((jax_synthetic, jax_compile_gates),
                            (synthetic, compile_gates)):
        top, _events = mod.synthetic_mef_tree(**kw)
        tree = compile_fn([top])
        tree.top_index = tree.gate_index[top.id]
        out.append(tree)
    return out


def shuffled_hier(**kw):
    return (jax_shuffle(jax_synthetic.synthetic_hierarchical_tree(**kw),
                        seed=1),
            random_shuffle(synthetic.synthetic_hierarchical_tree(**kw),
                           seed=1))


def test_random_shuffle_matches():
    js, ts = shuffled_hier(**HIER)
    assert np.array_equal(js.perm, ts.perm)
    assert_trees_equal(js.tree, ts.tree)
    x = np.arange(HIER["n_basic"], dtype=np.float64)
    assert np.array_equal(js.permute_basic(x), ts.permute_basic(x))


@pytest.mark.parametrize("method", ["first_use", "rcm", "auto"])
@pytest.mark.parametrize("hot_first", [False, True])
def test_locality_reorder_matches(method, hot_first):
    js, ts = shuffled_hier(**HIER)
    jr = jax_reorder(js.tree, method=method, hot_first=hot_first)
    tr = locality_reorder(ts.tree, method=method, hot_first=hot_first)
    assert np.array_equal(jr.perm, tr.perm)
    assert_trees_equal(jr.tree, tr.tree)


def test_reorder_of_all_families_matches_and_keeps_the_top():
    """Prod, pair and count blocks, sweeps and flip grouping; the
    reordered tree's f64 top equals the original's bit for bit."""
    jt, tt = mef_trees(n_basic=64, n_gates=48, fanin=4, seed=5,
                       atleast_fraction=0.3)
    jr = jax_reorder(jt, sweeps=2, group_flips=True)
    tr = locality_reorder(tt, sweeps=2, group_flips=True)
    assert np.array_equal(jr.perm, tr.perm)
    assert_trees_equal(jr.tree, tr.tree)
    p = np.random.default_rng(7).uniform(0.01, 0.3, (4, tt.n_basic))
    base = top_event_probability(tt, torch.from_numpy(p))
    got = top_event_probability(tr.tree,
                                torch.from_numpy(tr.permute_basic(p)))
    assert torch.equal(got, base)


def test_apply_permutation_matches_and_refuses_cross_block_moves():
    kw = dict(n_basic=64, n_gates=128, fanin=3, n_levels=4, seed=1)
    jt = jax_synthetic.synthetic_compiled_tree(**kw)
    tt = synthetic.synthetic_compiled_tree(**kw)
    perm = np.arange(tt.n_nodes)
    perm[:tt.n_basic] = np.random.default_rng(3).permutation(tt.n_basic)
    assert_trees_equal(jax_apply(jt, perm), apply_permutation(tt, perm))
    bad = np.arange(tt.n_nodes)
    a = int(tt.levels[0].prods[0].out_idx[0])
    b = int(tt.levels[-1].prods[0].out_idx[0])
    bad[a], bad[b] = b, a
    with pytest.raises(ValueError):
        apply_permutation(tt, bad)
