"""Torch port, the gather level kernel's plain version against the JAX package.

* On the 77-gate partial-tile tree of ``tests/test_gather_kernel.py``
  (uniform fan-in 3), the plain version equals the JAX kernel in
  interpret mode bit for bit, and the port's float32 gather engine.
* On a ragged product tree (``synthetic_mef_tree(n_basic=32, n_gates=40,
  fanin=4, seed=3)``, blocks padded with slot 0 and ``arg_mask`` False),
  the port equals the float32 gather engine of both packages bit for bit,
  and a test records the JAX kernel's defect there: it ignores
  ``arg_mask`` and multiplies basic event 0 into the padded positions,
  2.4e-2 relative off (the port does not copy it).
* The JAX refusals (house events, ``T % 1024``) and two of the port's
  own (pair or count gates, a matrix that is not float32) raise
  ``LogicError``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from canopy_tpu.compiler.graph import compile_gates as jax_compile_gates
from canopy_tpu.engine.propagate import \
    top_event_probability as jax_top_probability
from canopy_tpu.ops import gather_kernel as jgk
from canopy_tpu.utils import synthetic as jax_synthetic
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.engine.propagate import top_event_probability
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective, Formula,
                                        Gate, HouseEvent)
from canopy_tpu_torch.mef.expr.constant import ConstantExpression
from canopy_tpu_torch.ops import gather_kernel as tgk
from canopy_tpu_torch.utils import synthetic
from canopy_tpu_torch.utils.profiling import counters

from torch_parity import launches_since

PARTIAL = dict(n_basic=64, n_gates=77, fanin=3, n_levels=4, seed=5)
RAGGED = dict(n_basic=32, n_gates=40, fanin=4, seed=3)


def ragged_trees():
    out = []
    for mod, compile_fn in ((jax_synthetic, jax_compile_gates),
                            (synthetic, compile_gates)):
        top, _events = mod.synthetic_mef_tree(**RAGGED)
        tree = compile_fn([top])
        tree.top_index = tree.gate_index[top.id]
        out.append(tree)
    return out


def test_partial_tile_equals_jax_interpret():
    jt = jax_synthetic.synthetic_compiled_tree(**PARTIAL)
    tt = synthetic.synthetic_compiled_tree(**PARTIAL)
    p = np.random.default_rng(1).uniform(0, 1, (1024, tt.n_basic)) \
        .astype(np.float32)
    want = np.asarray(jgk.gather_propagate(jt, jnp.asarray(p),
                                           interpret=True))
    before = counters()
    got = tgk.gather_propagate(tt, torch.from_numpy(p))
    assert launches_since(before) == {}
    assert got.dtype == torch.float32 and got.shape == (1024,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tgk.gather_forward_plain(tt,
                                                     torch.from_numpy(p)))
    vals = tgk.stage_gather(tt, torch.from_numpy(p))
    assert torch.equal(tgk.gather_levels(tt, vals), got)
    assert torch.equal(got, top_event_probability(tt, torch.from_numpy(p)))


def test_ragged_tree_equals_gather_engine():
    jt, tt = ragged_trees()
    assert tgk.gather_supported(tt) and jgk.gather_supported(jt)
    assert any(not b.arg_mask.all() for lv in tt.levels for b in lv.prods)
    p = np.random.default_rng(0).uniform(0.05, 0.5, (1024, tt.n_basic)) \
        .astype(np.float32)
    got = tgk.gather_propagate(tt, torch.from_numpy(p))
    assert torch.equal(got, top_event_probability(tt, torch.from_numpy(p)))
    want = np.asarray(jax_top_probability(jt, jnp.asarray(p)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_jax_kernel_ignores_arg_mask_on_ragged_blocks():
    """The reference defect the port does not copy (ROADMAP.md, Queue
    3): the JAX kernel is 2.4e-2 relative off the gather engine here."""
    jt, _tt = ragged_trees()
    p = np.random.default_rng(0).uniform(0.05, 0.5, (1024, jt.n_basic)) \
        .astype(np.float32)
    kernel = np.asarray(jgk.gather_propagate(jt, jnp.asarray(p),
                                             interpret=True))
    engine = np.asarray(jax_top_probability(jt, jnp.asarray(p)))
    assert 1e-2 < np.max(np.abs(kernel - engine) / np.abs(engine)) < 5e-2


def test_uniform_fan_tree_equals_gather_engine():
    tt = synthetic.synthetic_compiled_tree(n_basic=256, n_gates=1000,
                                           fanin=4, n_levels=6, seed=3)
    p = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 0.9, (1024, tt.n_basic)).astype(np.float32))
    assert torch.equal(tgk.gather_propagate(tt, p),
                       top_event_probability(tt, p))


def test_refusals():
    tt = synthetic.synthetic_compiled_tree(**PARTIAL)
    with pytest.raises(LogicError, match="1024"):
        tgk.gather_propagate(tt, torch.zeros((100, tt.n_basic)))
    with pytest.raises(LogicError, match="probabilities"):
        tgk.gather_propagate(tt, torch.zeros((1024, tt.n_basic - 1)))
    with pytest.raises(LogicError):
        tgk.gather_level(torch.zeros((tt.n_nodes, 8), dtype=torch.float64),
                         tt.levels[0].prods[0])
    with pytest.raises(LogicError, match="rows"):
        tgk.gather_level(torch.zeros((tt.n_basic, 8)), tt.levels[0].prods[0])
    a, b = BasicEvent("a"), BasicEvent("b")
    a.expression = b.expression = ConstantExpression(0.1)
    top = Gate("top")
    top.formula = Formula(Connective.AND, [Arg(a), Arg(HouseEvent("h"))])
    house_tree = compile_gates([top])
    house_tree.top_index = house_tree.gate_index["top"]
    assert not tgk.gather_supported(house_tree)
    with pytest.raises(LogicError, match="house"):
        tgk.gather_propagate(house_tree,
                             torch.zeros((1024, house_tree.n_basic)))
    top = Gate("xor")
    top.formula = Formula(Connective.XOR, [Arg(a), Arg(b)])
    pair_tree = compile_gates([top])
    pair_tree.top_index = pair_tree.gate_index["xor"]
    assert not tgk.gather_supported(pair_tree)
    with pytest.raises(LogicError):
        tgk.gather_propagate(pair_tree, torch.zeros((1024, 2)))
