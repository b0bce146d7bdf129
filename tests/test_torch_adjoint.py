"""Torch port, reverse mode: the plain adjoint vs jax.grad and autograd.

* Against the JAX package: ``jax.grad`` through
  ``make_differentiable_stream(..., interpret=True)`` (its tape and
  adjoint Pallas kernels) on the same ``StreamProgram`` and numpy input.
  f32 on both sides, with FMA contraction possible on the XLA side:
  within 1e-5 relative plus 1e-7 absolute.
* Against torch autograd of the port's own plain forward, in f64: the
  adjoint is the exact derivative of the same arithmetic, so within
  1e-12 relative to the largest gradient.
* A hand-written program whose ops write the very pool slot one of their
  arguments reads (allowed by the linear-scan allocator) and that holds a
  spill, a count gate, a pair, an inverted product and a mux.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.schedule import StreamProgram, build_stream_schedule
from canopy_tpu.ops import stream_kernel as jsk
from canopy_tpu.ops.adjoint_kernel import (compile_adjoint,
                                           make_differentiable_stream)
from canopy_tpu_torch.ops import adjoint_kernel as tak
from canopy_tpu_torch.ops import stream_kernel as tsk

from test_adjoint import connective_tree
from test_stream_kernel import mixed_tree
from torch_parity import load_tree, overwriting_program


def _uniform(shape, seed, hi=1.0):
    return np.random.default_rng(seed).uniform(0.0, hi, shape) \
        .astype(np.float32)


def _jax_grad(program, house, basic):
    aprog = compile_adjoint(program)
    f = make_differentiable_stream(aprog, house, interpret=True)
    return np.asarray(jax.grad(
        lambda bp: f(jsk.stage_basic(program, bp)).sum())(
            jnp.asarray(basic)))


def _torch_grad(program, house, basic, dtype=torch.float32):
    enc = tsk.encode_stream(program)
    bp = torch.from_numpy(basic).to(dtype).requires_grad_(True)
    f = tak.make_differentiable_stream(enc, house)
    f(tsk.stage_basic(enc, bp, dtype)).sum().backward()
    return bp.grad.numpy()


@pytest.mark.parametrize("case", ["mixed-spilled", "connective",
                                  "aralia_like_ccf"])
def test_backward_matches_jax_grad(case):
    if case == "mixed-spilled":
        tree = mixed_tree()
        program = build_stream_schedule(tree, chunk_tiles=2, n_bufs=2)
    elif case == "connective":     # nand/nor/imply/cardinality/iff
        tree = connective_tree()
        program = jsk.compile_stream(tree, chunk_tiles=2)
    else:
        _model, tree = load_tree("canopy_tpu", case)
        program = jsk.compile_stream(tree)
    house = tree.house_state_vector()
    basic = _uniform((1024, tree.n_basic), seed=11)
    want = _jax_grad(program, house, basic)
    got = _torch_grad(program, house, basic)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def _assert_matches_autograd(enc, house, n_trials=64, seed=0, hi=1.0):
    """f64 plain backward == autograd of the f64 plain forward."""
    staged = torch.from_numpy(
        _uniform((enc.n_basic, n_trials), seed, hi)).double()
    ct = torch.from_numpy(_uniform(n_trials, seed + 1)).double() + 0.5
    h = tsk.house_tensor(enc, house, "cpu", torch.float64)
    top, log = tsk.stream_forward_plain(enc, staged, h, with_log=True)
    grad = tak.stream_backward(enc, staged, house, log, ct)
    s = staged.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        tsk.stream_forward_plain(enc, s, h)[0], s, ct)
    scale = want.abs().max()
    assert float((grad - want).abs().max()) <= 1e-12 * float(scale)
    return top


@pytest.mark.parametrize("case", ["aralia_like_ccf",
                                  "aralia_like_noncoherent",
                                  "ccf-bdd-module"])
def test_backward_is_autograd_of_plain_forward(case):
    if case == "ccf-bdd-module":
        from canopy_tpu_torch.compiler.modules import build_modular_bdd
        _model, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
        bdd = max(build_modular_bdd(tree).chain,
                  key=lambda c: c[0].n_nodes)[0]
        enc = tsk.encode_stream(tsk.compile_bdd_stream(bdd))
        house = []
    else:
        _model, tree = load_tree("canopy_tpu_torch", case)
        enc = tsk.encode_stream(tsk.compile_stream(tree))
        house = tree.house_state_vector()
    _assert_matches_autograd(enc, house, hi=0.3)


def test_overwriting_program():
    program = overwriting_program(StreamProgram)
    enc = tsk.encode_stream(program)
    basic = _uniform((1024, 6), seed=4)
    want = np.asarray(jsk.stream_propagate(program, jnp.asarray(basic),
                                           np.zeros(0), interpret=True))
    got = tsk.stream_propagate(enc, torch.from_numpy(basic), []).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    _assert_matches_autograd(enc, [], n_trials=256, seed=9)


def test_forward_without_grad_skips_the_log(monkeypatch):
    """Primal calls run the plain forward (no log); the log appears only
    when a gradient is tracked."""
    tree = mixed_tree()
    enc = tsk.encode_stream(jsk.compile_stream(tree, chunk_tiles=2))
    house = tree.house_state_vector()
    calls = []
    real = tsk.stream_forward

    def spy(enc_, staged, house_, with_log=False):
        calls.append(with_log)
        return real(enc_, staged, house_, with_log)
    monkeypatch.setattr(tak, "stream_forward", spy)
    f = tak.make_differentiable_stream(enc, house)
    basic = torch.from_numpy(_uniform((32, tree.n_basic), seed=2))
    plain = f(tsk.stage_basic(enc, basic))
    bp = basic.clone().requires_grad_(True)
    traced = f(tsk.stage_basic(enc, bp))
    assert calls == [False, True] and torch.equal(plain, traced.detach())
