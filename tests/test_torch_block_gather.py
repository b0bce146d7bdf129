"""Torch port, the block-gather engine against the JAX package's.

* ``compile_block_gather`` builds the same program as the JAX package's,
  field for field (every level's ranges, resident slabs, selections,
  flips and output flags), on reordered hierarchical trees of 1,024 and
  4,096 basic events; ``auto_t_tile`` gives 128-trial blocks whatever
  the windows, and refuses a cap under 128 as the JAX package does.
* The plain log mode is within 1e-5 relative of the JAX kernel in
  interpret mode at ``t_tile=128`` (the JAX sum runs in matmul column
  order, the port's in fan-in order); the plain direct mode equals the
  JAX kernel and the port's float32 gather engine bit for bit (a one-hot
  float32 product copies a value exactly).  JAX interpret runs use a
  73-gate tree; on the 585-gate tree, whose levels span several chunks,
  the port is held to its own float32 gather engine (log 1e-5 relative,
  direct bit-equal).
* Hard 0/1 inputs are exact in log mode (the log clamp); trial slabs of
  the plain version change nothing; every ``LogicError`` of the JAX
  tests is raised; ``make_propagator(engine="block")`` runs the plain
  version on the CPU and builds for CUDA without touching a device.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from canopy_tpu.compiler.reorder import locality_reorder as jax_reorder
from canopy_tpu.compiler.reorder import random_shuffle as jax_shuffle
from canopy_tpu.errors import LogicError as JaxLogicError
from canopy_tpu.ops import block_gather as jbg
from canopy_tpu.utils import synthetic as jax_synthetic
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.compiler.reorder import locality_reorder, random_shuffle
from canopy_tpu_torch.engine.propagate import (make_propagator,
                                               top_event_probability)
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import block_gather as tbg
from canopy_tpu_torch.utils import synthetic
from canopy_tpu_torch.utils.profiling import counters

from torch_parity import launches_since


def hier(pkg_synthetic, shuffle, reorder, n_basic, share=0.1):
    tree = pkg_synthetic.synthetic_hierarchical_tree(
        n_basic=n_basic, branching=8, share_fraction=share, n_shared=128,
        seed=0)
    return reorder(shuffle(tree, seed=1).tree, hot_first=True).tree


def port_tree(n_basic, share=0.1):
    return hier(synthetic, random_shuffle, locality_reorder, n_basic, share)


def jax_tree(n_basic, share=0.1):
    return hier(jax_synthetic, jax_shuffle, jax_reorder, n_basic, share)


def uniform(n_trials, n_basic, seed, hi):
    return np.random.default_rng(seed).uniform(
        0.0, hi, (n_trials, n_basic)).astype(np.float32)


def gather_f32(tree, p: np.ndarray) -> torch.Tensor:
    return top_event_probability(tree, torch.from_numpy(p))


@pytest.mark.parametrize("n_basic", [1024, 4096])
def test_compile_matches_jax(n_basic):
    jp = jbg.compile_block_gather(jax_tree(n_basic))
    tp = tbg.compile_block_gather(port_tree(n_basic))
    for field in ("n_basic", "n_rows", "top_index", "nnz"):
        assert getattr(jp, field) == getattr(tp, field), field
    assert jp.hbm_rows_per_level() == tp.hbm_rows_per_level()
    assert len(jp.levels) == len(tp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        assert jl.c_rows == tl.c_rows
        for field, value in vars(jl).items():
            other = getattr(tl, field)
            assert np.shape(value) == np.shape(other), field
            assert np.array_equal(value, other), field


def test_auto_t_tile_fits_shared_memory():
    """The kernels stage no window in shared memory, so no window caps
    the block: 128 trials on small and wide programs alike."""
    for n_basic in (512, 4096):
        program = tbg.compile_block_gather(port_tree(n_basic))
        assert tbg.auto_t_tile(program) == 128
        assert tbg.auto_t_tile(program, cap=128) == 128
    with pytest.raises(JaxLogicError):
        jbg.auto_t_tile(jbg.compile_block_gather(jax_tree(512)), cap=64)
    with pytest.raises(LogicError):
        tbg.auto_t_tile(program, cap=64)


@pytest.mark.parametrize("mode", ["log", "direct"])
def test_plain_matches_jax_interpret(mode):
    """The 73-gate tree (resident slabs on two levels), 128 trials."""
    tree = port_tree(512)
    p = uniform(128, tree.n_basic, 0, 0.9 if mode == "direct" else 0.4)
    want = np.asarray(jbg.block_gather_propagate(
        jbg.compile_block_gather(jax_tree(512)), jnp.asarray(p),
        t_tile=128, interpret=True, mode=mode))
    got = tbg.block_gather_propagate(tbg.compile_block_gather(tree),
                                     torch.from_numpy(p), t_tile=128,
                                     mode=mode)
    assert got.dtype == torch.float32 and got.shape == (128,)
    if mode == "log":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, gather_f32(tree, p))


def test_plain_matches_gather_engine_on_multi_chunk_levels():
    tree = port_tree(4096)
    program = tbg.compile_block_gather(tree)
    assert max(lv.n_chunks for lv in program.levels) > 1
    p = uniform(128, tree.n_basic, 3, 0.4)
    ref = gather_f32(tree, p)
    got = tbg.block_gather_propagate(program, torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=0)
    got = tbg.block_gather_propagate(program, torch.from_numpy(p),
                                     mode="direct")
    assert torch.equal(got, ref)


def test_hard_zero_one_inputs_exact():
    tree = port_tree(1024, share=0.0)
    program = tbg.compile_block_gather(tree)
    p = (np.random.default_rng(1).random((128, tree.n_basic)) < 0.5) \
        .astype(np.float32)
    got = tbg.block_gather_propagate(program, torch.from_numpy(p),
                                     t_tile=128)
    assert torch.equal(got, gather_f32(tree, p))


def test_trials_tiling(monkeypatch):
    tree = port_tree(1024)
    program = tbg.compile_block_gather(tree)
    p = torch.from_numpy(uniform(512, tree.n_basic, 2, 0.2))
    whole = tbg.block_gather_propagate(program, p, t_tile=128)
    np.testing.assert_allclose(whole.numpy(),
                               gather_f32(tree, p.numpy()).numpy(),
                               rtol=1e-5, atol=0)
    monkeypatch.setattr(tbg, "_PLAIN_TRIALS", 128)
    for mode in ("log", "direct"):
        sliced = tbg.block_gather_forward_plain(program, p, mode)
        assert torch.equal(sliced, tbg.block_gather_propagate(
            program, p, t_tile=128, mode=mode))
        # The staged matrix and the level-by-level pass the card runs.
        vals = tbg.stage_block_gather(program, p)
        assert torch.equal(
            tbg.block_gather_levels(program, vals, 128, mode), sliced)
    with pytest.raises(LogicError):
        tbg.block_gather_levels(program, vals, 96)
    with pytest.raises(LogicError):
        tbg.block_gather_levels(program, vals[:-1], 128)


def test_refusals():
    program = tbg.compile_block_gather(port_tree(512))
    n = program.n_basic
    with pytest.raises(LogicError):
        tbg.block_gather_propagate(program, torch.zeros((100, n)))
    with pytest.raises(LogicError):
        tbg.block_gather_propagate(program, torch.zeros((384, n)),
                                   t_tile=256)
    with pytest.raises(LogicError):
        tbg.block_gather_propagate(program, torch.zeros((128, n)),
                                   mode="matmul")
    with pytest.raises(LogicError):
        tbg.block_gather_forward_plain(program, torch.zeros((128, n)),
                                       mode="matmul")
    # Uniform-random structure has no locality to recover.
    tree = synthetic.synthetic_compiled_tree(n_basic=8192, n_gates=60_000,
                                             fanin=4, n_levels=10, seed=0)
    with pytest.raises(LogicError):
        tbg.compile_block_gather(locality_reorder(tree, hot_first=True).tree,
                                 r_max=2048)
    # The shuffled hierarchical tree needs the reorder first.
    shuffled = random_shuffle(synthetic.synthetic_hierarchical_tree(
        n_basic=4096, branching=8, share_fraction=0.1, n_shared=128,
        seed=0), seed=1).tree
    with pytest.raises(LogicError, match="r_max"):
        tbg.compile_block_gather(shuffled)


def test_supported_predicate():
    top, _ = synthetic.synthetic_mef_tree(n_basic=32, n_gates=24,
                                          atleast_fraction=0.5, seed=1)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    assert not tbg.block_gather_supported(tree)  # count gates
    with pytest.raises(LogicError):
        tbg.compile_block_gather(tree)
    assert tbg.block_gather_supported(port_tree(512))


def test_make_propagator_block():
    tree = port_tree(1024)
    fn = make_propagator(tree, "cpu", engine="block")
    assert fn.engine == "block"
    p = torch.from_numpy(uniform(256, tree.n_basic, 4, 0.3))
    before = counters()
    got = fn(p)
    assert launches_since(before) == {}
    assert torch.equal(got, tbg.block_gather_propagate(
        tbg.compile_block_gather(tree), p))
    np.testing.assert_allclose(got.numpy(), gather_f32(tree, p.numpy())
                               .numpy(), rtol=1e-5, atol=0)
    with pytest.raises(ValueError):
        fn(p, torch.zeros(0))
    with pytest.raises(ValueError):
        make_propagator(tree, "cpu", output="all", engine="block")
    shuffled = random_shuffle(synthetic.synthetic_hierarchical_tree(
        n_basic=4096, branching=8, share_fraction=0.1, n_shared=128,
        seed=0), seed=1).tree
    with pytest.raises(LogicError):
        make_propagator(shuffled, "cpu", engine="block")
    # Building for the card touches no device.
    assert make_propagator(tree, torch.device("cuda"),
                           engine="block").engine == "block"
