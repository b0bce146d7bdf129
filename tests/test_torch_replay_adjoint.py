"""Torch port, the replay adjoint on the CPU: plain taped forward, backward.

Tolerances:

* float32 gradient of ``make_differentiable_replay`` against the JAX
  package's (its taped-forward and backward Pallas kernels in interpret
  mode, as ``tests/test_replay_adjoint.py`` runs them), on the same
  program and numpy input: within 1e-5 of the largest gradient (the two
  sum partials in other orders);
* float64 gradient stream against torch autograd of the port's own plain
  forward, and the float64 basic gradient against autograd of the f64
  gather engine: within 1e-12 of the largest gradient (the same partials
  of the same arithmetic);
* against the vendored host simulator ``simulate_replay_adjoint`` (float32
  forward values, float64 partials): within 1e-5 of the largest
  gradient, the port running float64 throughout;
* importance through ``_make_replay_importance_fn`` (float64, one trial)
  against the JAX package's float64 gather autodiff: every measure within
  1e-12 relative (MIF relative to the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.replay_adjoint import \
    build_replay_adjoint as jax_build_adjoint
from canopy_tpu.engine.importance import \
    importance_measures as jax_importance
from canopy_tpu.ops.replay_adjoint_kernel import \
    make_differentiable_replay as jax_differentiable_replay
from canopy_tpu.ops.stream_kernel import stage_replay as jax_stage_replay
from canopy_tpu.utils.synthetic import \
    synthetic_compiled_tree as jax_synthetic
from canopy_tpu_torch.compiler.replay_adjoint import simulate_replay_adjoint
from canopy_tpu_torch.engine.importance import (_make_replay_importance_fn,
                                                importance_measures)
from canopy_tpu_torch.engine.propagate import make_propagator
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import replay_adjoint_kernel as trk
from canopy_tpu_torch.ops import stream_kernel as tsk
from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree

#: The JAX tests' adjoint schedules (tests/test_replay_adjoint.py): the
#: thrash-shaped one, and the one of their well-conditioned tree (seed
#: 9, top about 0.63, largest gradient about 1.6 at p ~ U(0.05, 0.6)).
ATHRASH = dict(tct=16, tape_bufs=3, tape_slab=8, gcot_bufs=2,
               icot_bufs=2, inj_chunk=4, inj_bufs=2, side_cap=32,
               brs_chunk=16, brs_bufs=3, grs_chunk=8, grs_bufs=2,
               slab_bufs=3, slab_tiles=8, max_ops_per_segment=150,
               pool_slots=12, hoist_events=8, n_refill_sems=4,
               n_flush_sems=2)
KSEED = 9
KCONF = dict(tct=16, tape_bufs=3, tape_slab=8, gcot_bufs=2,
             icot_bufs=2, inj_chunk=4, inj_bufs=2, side_cap=64,
             brs_chunk=16, brs_bufs=3, grs_chunk=8, grs_bufs=2,
             slab_bufs=2, slab_tiles=4, max_ops_per_segment=100,
             pool_slots=7, hoist_events=4, n_refill_sems=4,
             n_flush_sems=2)
KTREE = dict(n_basic=96, n_gates=900, fanin=4, n_levels=6, seed=KSEED)


def uniform(shape, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.6, shape)


def port_value_and_grad(aprog, p: np.ndarray, dtype):
    """(top values, d sum(top) / d p) through make_differentiable_replay
    and stage_replay's backward."""
    enc = tsk.encode_replay(aprog.base)
    f = trk.make_differentiable_replay(aprog, [])
    q = torch.from_numpy(p).to(dtype).requires_grad_(True)
    top = f(tsk.stage_replay(enc, q, dtype))
    top.sum().backward()
    return top.detach(), q.grad


def normwise(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want)).double()
    return float((got.double() - want).abs().max() / want.abs().max())


def test_gradient_matches_jax_interpret_kernels():
    tree = synthetic_compiled_tree(**KTREE)
    aprog = trk.compile_replay_adjoint(tree, **KCONF)
    b = aprog.base
    assert b.n_evicted and b.n_intra and b.n_inter and b.n_slab_reads
    japrog = jax_build_adjoint(jax_synthetic(**KTREE), **KCONF)
    assert japrog.base.segments == b.segments
    p = uniform((1024, tree.n_basic), KSEED).astype(np.float32)
    f = jax_differentiable_replay(japrog, np.zeros(0, np.float32),
                                  interpret=True)
    jval, jgrad = jax.value_and_grad(
        lambda bp: f(jax_stage_replay(japrog.base, bp)).sum())(
            jnp.asarray(p))
    top, grad = port_value_and_grad(aprog, p, torch.float32)
    assert float(top.sum()) == pytest.approx(float(jval), rel=1e-6)
    assert normwise(grad, jgrad) < 1e-5


@pytest.mark.parametrize("case", ["thrash-0", "thrash-1", "thrash-2",
                                  "kconf", "default-sizing"])
def test_f64_gradient_is_autograd_of_gather(case):
    if case == "kconf":
        tree = synthetic_compiled_tree(**KTREE)
        config = KCONF
    else:
        seed = 0 if case == "default-sizing" else int(case[-1])
        tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                       n_levels=10, seed=seed)
        config = {} if case == "default-sizing" else ATHRASH
    aprog = trk.compile_replay_adjoint(tree, **config)
    if config:
        assert aprog.base.n_evicted and aprog.base.n_inter
    p = uniform((16, tree.n_basic), 1)
    top, grad = port_value_and_grad(aprog, p, torch.float64)
    q = torch.from_numpy(p).requires_grad_(True)
    want_top = make_propagator(tree, "cpu", engine="gather")(q)
    want_top.sum().backward()
    want_top = want_top.detach()
    assert float((top - want_top).abs().max()) <= \
        1e-12 * float(want_top.abs().max())
    assert normwise(grad, q.grad) <= 1e-12


def test_backward_is_autograd_of_plain_forward():
    """The gradient stream itself, f64, against autograd of the plain
    replay forward on the staged stream (a program with refills, slab and
    gate-stream reads, evictions and a shared adjoint log)."""
    tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                   n_levels=10, seed=3)
    enc = tsk.encode_replay(trk.compile_replay_adjoint(tree,
                                                       **ATHRASH).base)
    staged = tsk.stage_replay(enc, torch.from_numpy(uniform(
        (32, tree.n_basic), 3)), torch.float64)
    ct = torch.from_numpy(uniform(32, 4)) + 0.5
    house = torch.zeros(1, dtype=torch.float64)
    top, vlog = trk.replay_tape_forward(enc, staged, [])
    ptop, plog = tsk.replay_forward_plain(enc, staged, house, True)
    assert torch.equal(top, ptop) and torch.equal(vlog, plog)
    assert vlog.shape == (enc.n_log, 32)
    grad = trk.replay_adjoint_backward(enc, staged, [], vlog, ct)
    s = staged.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        tsk.replay_forward_plain(enc, s, house)[0], s, ct)
    assert normwise(grad, want) <= 1e-12
    # Padding rows of the stream carry no gradient.
    pad = np.setdiff1d(np.arange(enc.n_basic), enc.read_rows)
    assert not grad[pad].any()


@pytest.mark.parametrize("seed", [KSEED, KSEED + 1])
def test_matches_vendored_simulator(seed):
    """On the well-conditioned tree (deeper synthetic trees have tops
    near 1e-27, where float32 forward values lose most digits)."""
    tree = synthetic_compiled_tree(**KTREE)
    aprog = trk.compile_replay_adjoint(tree, **KCONF)
    assert aprog.base.n_evicted and aprog.base.n_inter
    p = uniform((1, tree.n_basic), seed)
    top, grad = port_value_and_grad(aprog, p, torch.float64)
    sim_top, sim_grad = simulate_replay_adjoint(aprog, p[0], np.zeros(0))
    assert abs(float(top[0]) - sim_top) <= 1e-6 * abs(sim_top)
    assert normwise(grad[0], sim_grad) <= 1e-5


def test_importance_via_replay_adjoint():
    """``importance_measures`` with the replay top_fn against the JAX
    package's f64 gather autodiff on the same tree and point."""
    tree = synthetic_compiled_tree(**KTREE)
    jtree = jax_synthetic(**KTREE)
    p = uniform(tree.n_basic, KSEED)
    got = importance_measures(tree, torch.from_numpy(p),
                              top_fn=_make_replay_importance_fn(tree, None,
                                                                "cpu"))
    want = jax_importance(jtree, jnp.asarray(p), jnp.zeros(0))
    assert got.top_probability == pytest.approx(want.top_probability,
                                                rel=1e-12)
    mif = np.asarray(want.mif)
    np.testing.assert_allclose(got.mif, mif, rtol=0,
                               atol=1e-12 * np.abs(mif).max())
    for name in ("cif", "dif", "raw", "rrw"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-12)


def test_forward_without_grad_skips_the_tape(monkeypatch):
    tree = synthetic_compiled_tree(**KTREE)
    aprog = trk.compile_replay_adjoint(tree, **KCONF)
    enc = tsk.encode_replay(aprog.base)
    calls = []
    real = trk.replay_forward

    def spy(enc_, staged, house_, with_log=False):
        calls.append(with_log)
        return real(enc_, staged, house_, with_log)
    monkeypatch.setattr(trk, "replay_forward", spy)
    f = trk.make_differentiable_replay(aprog, [])
    p = torch.from_numpy(uniform((8, tree.n_basic), 2))
    plain = f(tsk.stage_replay(enc, p))
    traced = f(tsk.stage_replay(enc, p.clone().requires_grad_(True)))
    assert calls == [False, True] and torch.equal(plain, traced.detach())


def test_adjoint_refuses_a_resident_tier():
    tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                   n_levels=10, seed=0)
    program = tsk.compile_replay_stream(tree, resident_tiles=16)
    assert program.res_tiles
    enc = tsk.encode_replay(program)
    staged = tsk.stage_replay(enc, torch.from_numpy(uniform(
        (4, tree.n_basic), 0)))
    top, vlog = trk.replay_tape_forward(enc, staged, [])
    with pytest.raises(LogicError):
        trk.replay_adjoint_backward(enc, staged, [], vlog, top)
    aprog = trk.compile_replay_adjoint(tree, resident_tiles=16)
    assert aprog.base.res_tiles == 0
    assert aprog.base.pool_slots == 113
