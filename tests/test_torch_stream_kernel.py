"""Torch port, stream programs: encoder + plain forward vs the JAX kernel.

The same ``StreamProgram`` (built once by the JAX package's scheduler) and
the same numpy input go through ``canopy_tpu.ops.stream_kernel`` in Pallas
interpret mode and through the port's encoder and plain PyTorch forward.

Tolerance: f32 within 1e-6 relative.  Both evaluate every gate in the
same op order, but XLA's CPU code may contract a multiply and an add into
one FMA where the port rounds each (as its CUDA kernel does, built with
``--fmad=false``), so results may differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.modules import build_modular_bdd
from canopy_tpu.compiler.schedule import build_stream_schedule
from canopy_tpu.engine.bdd_eval import bdd_probability as jax_bdd_probability
from canopy_tpu.ops import stream_kernel as jsk
from canopy_tpu_torch.ops import stream_kernel as tsk

from test_stream_kernel import mixed_tree
from torch_parity import load_tree

RTOL = 1e-6


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape) \
        .astype(np.float32)


def _largest_module(name):
    _model, tree = load_tree("canopy_tpu", name)
    modular = build_modular_bdd(tree)
    return tree, max(modular.chain, key=lambda c: c[0].n_nodes)[0]


def _tree_case(case):
    if case == "mixed-spilled":
        # A 2-deep ring of 2-tile chunks: shared events outlive their
        # chunk and are spilled into the pool.
        tree = mixed_tree()
        return tree, build_stream_schedule(tree, chunk_tiles=2, n_bufs=2)
    _model, tree = load_tree("canopy_tpu", case)
    return tree, jsk.compile_stream(tree)


@pytest.mark.parametrize("case,n_trials", [
    ("aralia_like_ccf", 1024),          # prod + count
    ("aralia_like_noncoherent", 2048),  # prod + pair + count
    ("mixed-spilled", 1024),            # spills, house constant, pair
])
def test_tree_program_matches_jax_kernel(case, n_trials):
    tree, program = _tree_case(case)
    basic = _uniform((n_trials, tree.n_basic), seed=n_trials)
    house = tree.house_state_vector()
    want = np.asarray(jsk.stream_propagate(program, jnp.asarray(basic),
                                           house, interpret=True))
    enc = tsk.encode_stream(program)
    got = tsk.stream_propagate(enc, torch.from_numpy(basic), house).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    kinds = {op[1] for op in program.ops if op[0] == "gate"}
    assert kinds >= {"prod", "count"}
    if case == "mixed-spilled":
        assert any(op[0] == "spill" for op in program.ops)
        assert tree.n_house and kinds >= {"pair"}


@pytest.mark.parametrize("n_trials", [1024, 2048])
def test_bdd_module_matches_jax_kernel(n_trials):
    """The 287-node module of aralia_like_ccf as a mux program."""
    tree, bdd = _largest_module("aralia_like_ccf")
    assert bdd.n_nodes == 287
    program = jsk.compile_bdd_stream(bdd)
    values = _uniform((n_trials, tree.n_nodes), seed=7)
    want = np.asarray(jsk.stream_bdd_probability(
        program, jnp.asarray(values), interpret=True))
    got = tsk.stream_bdd_probability(tsk.encode_stream(program),
                                     torch.from_numpy(values)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_large_bdd_module_matches_jax_level_evaluation():
    """The 1,175-node BDD of aralia_like_medium: the JAX kernel in
    interpret mode takes about a minute here, so the JAX reference is
    its f32 level evaluation (the same Shannon arithmetic)."""
    tree, bdd = _largest_module("aralia_like_medium")
    assert bdd.n_nodes == 1175
    program = jsk.compile_bdd_stream(bdd)
    values = _uniform((1024, tree.n_nodes), seed=3)
    want = np.asarray(jax.jit(lambda v: jax_bdd_probability(bdd, v))(
        jnp.asarray(values)))
    got = tsk.stream_bdd_probability(tsk.encode_stream(program),
                                     torch.from_numpy(values)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["aralia_like_ccf", "aralia_like_medium"])
def test_port_bdd_schedule_encodes_like_the_shared_one(name):
    """The port's BDD scheduler (no TPU caps, one staging chunk) keeps the
    shared scheduler's op order, staging order and pool allocation: where
    the shared one spills nothing, both encode to the same tables."""
    _tree, bdd = _largest_module(name)
    want = tsk.encode_stream(jsk.compile_bdd_stream(bdd))
    got = tsk.encode_stream(tsk.compile_bdd_stream(bdd))
    for field in ("ops", "args", "fill", "staged_cols"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert (got.n_basic, got.pool_slots, got.top_slot, got.n_log) == \
        (want.n_basic, want.pool_slots, want.top_slot, want.n_log)


def test_encoder_tables():
    """DMA ops vanish, stage locations become staged rows, spills become
    SPILL ops, and every pool argument's backward source is the log row
    of the op that last wrote that slot."""
    tree, program = _tree_case("mixed-spilled")
    enc = tsk.encode_stream(program)
    n_gates = sum(op[0] == "gate" for op in program.ops)
    n_spills = sum(op[0] == "spill" for op in program.ops)
    assert enc.n_ops == n_gates + n_spills and enc.n_log == n_gates
    assert (enc.ops[:, 0] == tsk.SPILL).sum() == n_spills > 0
    staged = enc.args[enc.args[:, 0] == tsk.STAGED]
    assert staged[:, 1].max() < enc.n_basic
    assert np.array_equal(enc.staged_cols, program.basic_perm)
    pool_args = enc.args[enc.args[:, 0] == tsk.POOL]
    assert set(pool_args[:, 3]) <= {tsk.LOG, tsk.STAGED}
    # The cheaper count DP: upper-open (hi >= n) lo + 1 states, bounded
    # hi + 2, or the same over the complements' window [n - hi, n - lo].
    def states(lo, hi, n):
        return lo + 1 if hi >= n else hi + 2
    assert enc.max_count_states == max(
        min(states(lo, hi, len(op[3])),
            states(max(len(op[3]) - hi, 0), len(op[3]) - lo, len(op[3])))
        for op in program.ops if op[0] == "gate" and op[1] == "count"
        for lo, hi in [op[4]])


def test_any_trial_count_and_per_trial_independence():
    """No 1024-trial grid: a ragged batch gives each trial the value it
    gets inside a larger batch (one trial per thread on the card)."""
    tree, program = _tree_case("mixed-spilled")
    enc = tsk.encode_stream(program)
    basic = torch.from_numpy(_uniform((1024, tree.n_basic), seed=5))
    house = tree.house_state_vector()
    full = tsk.stream_propagate(enc, basic, house)
    part = tsk.stream_propagate(enc, basic[:1000], house)
    assert torch.equal(part, full[:1000])


def test_stage_unstage_adjoint():
    tree = mixed_tree()
    enc = tsk.encode_stream(jsk.compile_stream(tree, chunk_tiles=2))
    basic = torch.from_numpy(_uniform((64, tree.n_basic), seed=1))
    staged = tsk.stage_basic(enc, basic)
    assert staged.shape == (tree.n_basic, 64)
    assert torch.equal(tsk.unstage_basic(enc, staged, tree.n_basic), basic)

