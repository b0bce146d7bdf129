"""Torch port, fused whole-tree kernels: plain versions vs the JAX package.

* The plain versions of ``fused_propagate_tiled``, ``fused_propagate``
  and ``fused_propagate_tiled_staged`` (what the CUDA kernel of
  ``csrc/fused.cu`` computes, run here on CPU tensors) against the JAX
  package's Pallas kernels in interpret mode, on the same numpy inputs:
  within 1e-6 relative plus 2^-24 absolute.  Both run float32 in the
  same op order, but XLA's CPU code contracts multiply-adds (``1 - a*b``
  becomes one FMA) while the port rounds each operation; where a gate
  takes ``1 - x`` of an ``x`` near 1 (an OR of small probabilities is
  ``1 - prod(1 - p)``), that moves the result by up to an ulp of 1.0,
  2^-24, which is far more than 1e-6 of a result near 1e-4.  Trees:
  ``aralia_like_ccf``, ``aralia_like_noncoherent``, ``demo_plant``
  (a house event) and a small synthetic tree with count gates; 1,024
  trials (the JAX tiled kernel's grid) and 200 (a ragged count, against
  the JAX lane-row kernel).
* The op table follows the JAX kernels' gate order; the two ``*_supported``
  predicates sit at the shared-memory limits (454 and 1,816 gates); the
  wrappers take any trial count and refuse wrong inputs.
* The kernel's live-row program (``fused_program``): no row holds two
  live values, and the ring kernel's walk of its op stream
  (``torch_parity.walk_ring``) is bit-equal to the plain version and
  within the tolerance above of the JAX kernels in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.graph import compile_gates as jax_compile_gates
from canopy_tpu.ops import pallas_kernels as jpk
from canopy_tpu.utils.synthetic import synthetic_mef_tree as jax_synthetic
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.compiler.schedule import _emit_gate_ops
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import fused_kernel as tfk
from canopy_tpu_torch.ops.stream_kernel import (POOL,
                                                house_tensor,
                                                replay_ring_stream)
from canopy_tpu_torch.utils.profiling import counters
from canopy_tpu_torch.utils.synthetic import synthetic_mef_tree

from torch_parity import launches_since, load_tree, walk_ring

RTOL = 1e-6
ATOL = 2.0 ** -24
TREES = ["aralia_like_ccf", "aralia_like_noncoherent", "demo_plant",
         "synthetic-count"]


def synthetic_count_tree(pkg: str):
    """A 40-event, 30-gate synthetic tree, a third of its gates 2-of-k
    votes and some complemented AND arguments, from either package."""
    make, compile_ = ((jax_synthetic, jax_compile_gates)
                      if pkg == "canopy_tpu"
                      else (synthetic_mef_tree, compile_gates))
    top, _events = make(n_basic=40, n_gates=30, fanin=4, seed=5,
                        atleast_fraction=0.35, complement_fraction=0.2)
    tree = compile_([top])
    tree.top_index = tree.gate_index[top.id]
    return tree


def trees(name: str):
    """(JAX tree, port tree) of a case of ``TREES``."""
    if name == "synthetic-count":
        return synthetic_count_tree("canopy_tpu"), \
            synthetic_count_tree("canopy_tpu_torch")
    tree_name = "Cooling" if name == "demo_plant" else None
    return (load_tree("canopy_tpu", name, tree_name=tree_name)[1],
            load_tree("canopy_tpu_torch", name, tree_name=tree_name)[1])


def inputs(n_basic: int, n_trials: int, seed: int) -> np.ndarray:
    """PRA-scale probabilities (log-uniform over 1e-4..0.3), float32."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-4), np.log(0.3),
                              (n_trials, n_basic))).astype(np.float32)


def assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_synthetic_tree_has_count_gates_and_both_packages_agree():
    jt, tt = trees("synthetic-count")
    assert "count" in {op[0] for op in _emit_gate_ops(tt)}
    assert (jt.n_basic, jt.n_gates, jt.top_index) == \
        (tt.n_basic, tt.n_gates, tt.top_index)


@pytest.mark.parametrize("name", TREES)
def test_tiled_and_lane_row_match_jax_at_1024(name):
    jt, tt = trees(name)
    p = inputs(tt.n_basic, 1024, 11)
    house = tt.house_state_vector()
    assert tfk.fused_tiled_supported(tt) and tfk.fused_supported(tt)
    want = jpk.fused_propagate_tiled(jt, jnp.asarray(p), house,
                                     interpret=True)
    t = torch.from_numpy(p)
    got_tiled = tfk.fused_propagate_tiled(tt, t, house)
    assert got_tiled.dtype == torch.float32
    assert_close(got_tiled, want)
    # Same op order, only the block width differs: identical arithmetic
    # (the JAX lane-row kernel is held to the port at 200 trials below).
    assert torch.equal(tfk.fused_propagate(tt, t, house), got_tiled)


@pytest.mark.parametrize("name", TREES)
def test_ragged_trial_count_matches_jax_lane_row(name):
    jt, tt = trees(name)
    p = inputs(tt.n_basic, 200, 12)
    house = tt.house_state_vector()
    want = jpk.fused_propagate(jt, jnp.asarray(p), house, interpret=True)
    t = torch.from_numpy(p)
    assert_close(tfk.fused_propagate(tt, t, house), want)
    assert_close(tfk.fused_propagate_tiled(tt, t, house), want)


@pytest.mark.parametrize("name", ["demo_plant", "synthetic-count"])
def test_staged_matches_jax_staged(name):
    jt, tt = trees(name)
    p = inputs(tt.n_basic, 1024, 13)
    house = tt.house_state_vector()
    want = jpk.fused_propagate_tiled_staged(
        jt, jpk.tile_trials(jnp.asarray(p)), house, interpret=True)
    t = torch.from_numpy(p)
    staged = tfk.tile_trials(t)
    assert staged.shape == (tt.n_basic, 1024) and staged.is_contiguous()
    got = tfk.fused_propagate_tiled_staged(tt, staged, house)
    assert_close(got, want)
    assert torch.equal(got, tfk.fused_propagate_tiled(tt, t, house))


def test_house_states_are_baked_as_float32():
    _jt, tt = trees("demo_plant")
    assert tt.n_house == 1
    p = torch.from_numpy(inputs(tt.n_basic, 64, 14))
    on = tfk.fused_propagate_tiled(tt, p, np.ones(1))
    off = tfk.fused_propagate_tiled(tt, p, np.zeros(1))
    assert not torch.equal(on, off)
    with pytest.raises(LogicError):
        tfk.fused_propagate_tiled(tt, p, np.zeros(2))


def test_op_table_follows_the_jax_gate_order():
    _jt, tt = trees("synthetic-count")
    enc = tfk.encode_fused(tt)
    assert tfk.encode_fused(tt) is enc          # Cached on the tree.
    base = tt.n_basic + tt.n_house
    rows = _emit_gate_ops(tt)
    assert enc.n_ops == len(rows) == tt.n_gates
    assert enc.top_slot == tt.top_index - base
    for (kind, out, args, _aux), op in zip(rows, enc.ops):
        assert op[1] == out - base
        assert op[3] - op[2] == len(args)
        for (slot, flag), arg in zip(args, enc.args[op[2]:op[3]]):
            assert arg[2] == int(flag)
            assert arg[1] == (slot if slot < tt.n_basic else slot - base)


@pytest.mark.parametrize("name,tiled,lane", [
    ("torch_slice_plant", True, True),
    ("aralia_like_large", False, True),
    ("aralia_like_nested_count", False, True)])
def test_supported_predicates(name, tiled, lane):
    tree_name = "slice" if name == "torch_slice_plant" else None
    _m, tree = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    assert tfk.fused_tiled_supported(tree) is tiled
    assert tfk.fused_supported(tree) is lane


def test_supported_limits_are_the_shared_memory():
    """The predicates name the TPU counterpart by the gates one block's
    shared memory holds at its row width (454 at 128 trials, 1,816 at
    32).  The kernel's own sizing comes from the program
    (``fused_plan``): its rows live in device memory and a block's shared
    memory holds two op-stream chunks and the ring, so the plan fits a
    tree of any size, and its rows are the peak live set, not the
    gates."""
    assert tfk.SMEM_BYTES // (tfk.TILED_TRIALS * 4) == 454
    assert tfk.SMEM_BYTES // (tfk.LANE_TRIALS * 4) == 1816
    _jt, tt = trees("aralia_like_ccf")
    for n_gates, tiled, lane in [(454, True, True), (455, False, True),
                                 (1816, False, True), (1817, False, False)]:
        tt.n_gates = n_gates
        assert tfk.fused_tiled_supported(tt) is tiled
        assert tfk.fused_supported(tt) is lane
    for name in ("aralia_like_ccf", "aralia_like_nested_count"):
        enc = tfk.encode_fused(trees(name)[1])
        live, plan = tfk.fused_plan(enc)
        ring_rows = plan.depth if plan.depth > 1 else 0
        assert plan.width == tfk.FUSED_BLOCK_TRIALS
        assert plan.shared_bytes == 16 + 8 * plan.chunk_words + \
            ring_rows * plan.width * 4 <= tfk.SMEM_BYTES
        assert live.pool_slots < enc.pool_slots
        assert plan.chunk_words * 4 * 2 + 16 < tfk.SMEM_BYTES


def test_wrappers_refuse_and_count_nothing_on_the_cpu():
    _jt, tt = trees("aralia_like_ccf")
    enc = tfk.encode_fused(tt)
    before = counters()
    p = torch.from_numpy(inputs(tt.n_basic, 3, 15))
    assert tfk.fused_propagate(tt, p, []).shape == (3,)
    assert launches_since(before) == {}
    with pytest.raises(LogicError):
        tfk.fused_forward(enc, tfk.tile_trials(p).double(), [])
    with pytest.raises(LogicError):
        tfk.fused_forward(enc, tfk.tile_trials(p)[1:], [], tiled=True)
    with pytest.raises(LogicError, match="top"):
        tfk.fused_forward(dataclasses.replace(enc, top_slot=-1),
                          tfk.tile_trials(p), [])


LIVE_TREES = TREES + ["torch_slice_plant", "aralia_like_large",
                      "aralia_like_nested_count"]


def port_tree(name: str):
    if name in TREES:
        return trees(name)[1]
    tree_name = "slice" if name == "torch_slice_plant" else None
    return load_tree("canopy_tpu_torch", name, tree_name=tree_name)[1]


@pytest.mark.parametrize("name", LIVE_TREES)
def test_no_two_live_values_share_a_row(name):
    """Walking the live-row program, every gate argument finds in its row
    the very gate the JAX-order table names (no later gate wrote the row
    while that value was live), the top's row holds the top at the end,
    the ops keep their order and arithmetic, and the rows are the peak
    live set (fewer than the gates)."""
    enc = tfk.encode_fused(port_tree(name))
    live = tfk.fused_program(enc)
    assert tfk.fused_program(enc) is live       # cached on the table
    np.testing.assert_array_equal(live.ops[:, [0, 2, 3, 4, 5]],
                                  enc.ops[:, [0, 2, 3, 4, 5]])
    np.testing.assert_array_equal(live.args[:, [0, 2]], enc.args[:, [0, 2]])
    pool = enc.args[:, 0] == POOL
    np.testing.assert_array_equal(live.args[~pool], enc.args[~pool])
    holds: dict = {}          # live row -> gate (old row) whose value
    peak = 0
    for (b, e), gate, row in zip(enc.ops[:, 2:4].tolist(),
                                 enc.ops[:, 1].tolist(),
                                 live.ops[:, 1].tolist()):
        for j in range(b, e):
            if enc.args[j, 0] == POOL:
                assert holds[int(live.args[j, 1])] == enc.args[j, 1]
        holds[row] = gate
        peak = max(peak, len(holds))
    assert holds[live.top_slot] == enc.top_slot
    assert live.pool_slots == peak <= enc.pool_slots
    if enc.n_ops > 100:
        assert live.pool_slots < enc.pool_slots


@pytest.mark.parametrize("name", TREES)
def test_live_program_walk_matches_plain_and_jax(name):
    """The ring kernel's walk of the live-row program's op stream, at the
    plan's ring depth, bit-equal to ``fused_forward_plain`` on the
    JAX-order table, and within the tolerance above of the JAX tiled
    kernel (1,024 trials) and lane-row kernel (200 trials) in interpret
    mode."""
    jt, tt = trees(name)
    enc = tfk.encode_fused(tt)
    live, plan = tfk.fused_plan(enc)
    ring = replay_ring_stream(live, plan.depth)
    house = tt.house_state_vector()
    h32 = house_tensor(enc, house, "cpu")
    for n, jax_fn, seed in ((1024, jpk.fused_propagate_tiled, 16),
                            (200, jpk.fused_propagate, 17)):
        p = inputs(tt.n_basic, n, seed)
        staged = tfk.tile_trials(torch.from_numpy(p))
        got, _ = walk_ring(live, ring, staged, h32)
        assert torch.equal(got, tfk.fused_forward_plain(enc, staged, h32))
        assert_close(got, jax_fn(jt, jnp.asarray(p), house, interpret=True))
