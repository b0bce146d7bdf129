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
  1e-12 relative (MIF relative to the largest); its MIF against the
  port's stream adjoint within ``REPLAY_MIF_RTOL`` (1e-12, both f64), and
  against the JAX package's own replay importance (float32 kernels in
  interpret mode, 1,024 lanes) within 1e-4 relative of the largest;
* the level form of the backward (the kernel's gather order) against the
  sequential walk: bit-equal (``torch.equal``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.replay_adjoint import \
    build_replay_adjoint as jax_build_adjoint
import canopy_tpu.engine.importance as jax_importance_module
from canopy_tpu.engine.importance import \
    importance_measures as jax_importance
from canopy_tpu.ops.replay_adjoint_kernel import \
    make_differentiable_replay as jax_differentiable_replay
from canopy_tpu.ops.stream_kernel import stage_replay as jax_stage_replay
from canopy_tpu.utils.synthetic import \
    synthetic_compiled_tree as jax_synthetic
from canopy_tpu_torch.compiler.replay_adjoint import simulate_replay_adjoint
from canopy_tpu_torch.engine.importance import (_make_replay_importance_fn,
                                                importance_measures,
                                                make_stream_importance_fn)
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
    assert aprog.base.pool_slots == 56


#: chip_smoke.py's replay-adjoint tree (16,384 gates, 9,044 in the top
#: cone) and its forced small schedule's pool; the MIF tolerance of the
#: replay importance against the stream adjoint's.
ADJOINT_TREE = dict(n_basic=8192, n_gates=16384, fanin=4, n_levels=14,
                    seed=0)
SMALL_POOL = 256
REPLAY_MIF_RTOL = 1e-12


def level_cases():
    """(label, adjoint program, dtype, trials): the 16k tree's default
    program, its small schedule (evictions, slab, intra-segment and
    inter-segment reads, refills) and the thrash schedule."""
    tree16 = synthetic_compiled_tree(**ADJOINT_TREE)
    thrash = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                     n_levels=10, seed=0)
    return [
        ("16k", trk.compile_replay_adjoint(tree16, max_ops_per_segment=2048),
         torch.float64, 3),
        ("16k-small", trk.compile_replay_adjoint(
            tree16, pool_slots=SMALL_POOL, max_ops_per_segment=2048),
         torch.float32, 2),
        ("thrash", trk.compile_replay_adjoint(thrash, **ATHRASH),
         torch.float32, 8)]


def test_level_backward_equals_the_sequential_walk():
    """The level-parallel backward's plain version (levels in reverse,
    edge slots, each adjoint the fold of its consumers' edges, EVICT and
    REFILL as copy ops) is bit-equal to the sequential walk."""
    for label, aprog, dtype, n in level_cases():
        base = aprog.base
        if label == "16k-small":
            assert all((base.n_evicted, base.n_slab_reads, base.n_intra,
                        base.n_inter))
        enc = tsk.encode_replay(base)
        p = np.random.default_rng(n).uniform(0.0, 0.05, (n, enc.n_columns))
        staged = tsk.stage_replay(enc, torch.from_numpy(p), dtype)
        h = torch.zeros(1, dtype=dtype)
        _top, vlog = tsk.replay_forward_plain(enc, staged, h, True)
        ct = torch.linspace(0.5, 1.5, n, dtype=dtype)
        want = trk.replay_backward_plain(enc, staged, h, vlog, ct)
        got = trk.replay_backward_levels_plain(enc, staged, h, vlog, ct)
        assert torch.equal(got, want), label


def test_replay_level_schedule():
    """The host level schedule of the replay backward: every pool and
    eviction-log argument (and each EVICT/REFILL copy's one argument) has
    exactly one producer, every basic-stream argument one gradient row,
    levels rise strictly along every edge, the top op writes the top
    slot last, and the 16k tree keeps a short critical path."""
    for label, aprog, _dtype, _n in level_cases():
        enc = tsk.encode_replay(aprog.base)
        prog = trk.replay_level_program(enc)
        sched = tsk.level_schedule(prog)
        ops, args = prog.ops, prog.args
        op_of = np.repeat(np.arange(len(ops)), ops[:, 3] - ops[:, 2])
        level = np.empty(len(ops), dtype=np.int64)
        for lv in range(sched.n_levels):
            level[sched.order[sched.level_ptr[lv]:sched.level_ptr[lv + 1]]] \
                = lv
        producer = np.full(len(args), -1)
        for o in range(len(ops)):
            rows = sched.cons[sched.cons_ptr[o]:sched.cons_ptr[o + 1]]
            assert (producer[rows] == -1).all(), label
            producer[rows] = o
        pooled = args[:, 0] == tsk.POOL
        assert (producer[pooled] >= 0).all() and \
            (producer[~pooled] == -1).all(), label
        assert (level[producer[pooled]] < level[op_of[pooled]]).all()
        staged = np.flatnonzero(args[:, 0] == tsk.STAGED)
        np.testing.assert_array_equal(np.sort(sched.stage_cons), staged)
        # Each basic-stream row is read once: one edge per gradient row.
        assert (np.diff(sched.stage_ptr) <= 1).all()
        kinds = enc.ops[:, 0]
        assert (ops[(kinds == tsk.EVICT) | (kinds == tsk.REFILL), 0]
                == tsk.SPILL).all()
        writes = np.flatnonzero((enc.ops[:, 1] == enc.top_slot)
                                & (kinds != tsk.EVICT))
        assert sched.top_op == writes[-1]
        if label.startswith("16k"):   # 14 tree levels, and copies
            assert sched.n_levels <= 32, label


def test_replay_importance_matches_stream_and_jax():
    """One f64 trial through the replay adjoint: MIF within
    ``REPLAY_MIF_RTOL`` of the stream adjoint's, and within 1e-4 of the
    JAX package's ``_make_replay_importance_fn`` (float32 lanes, its
    kernels in interpret mode)."""
    tree = synthetic_compiled_tree(**KTREE)
    jtree = jax_synthetic(**KTREE)
    p = uniform(tree.n_basic, KSEED)
    got = importance_measures(tree, torch.from_numpy(p),
                              top_fn=_make_replay_importance_fn(tree, None,
                                                                "cpu"))
    stream = importance_measures(tree, torch.from_numpy(p),
                                 top_fn=make_stream_importance_fn(
                                     tree, None, "cpu"))
    big = np.abs(stream.mif).max()
    assert np.abs(got.mif - stream.mif).max() <= REPLAY_MIF_RTOL * big
    house = np.zeros(0, np.float32)
    jfn = jax_importance_module._make_replay_importance_fn(
        jtree, house, interpret=True)
    want = jax_importance(jtree, jnp.asarray(p, jnp.float32),
                          jnp.asarray(house), top_fn=jfn)
    mif = np.asarray(want.mif, dtype=np.float64)
    assert np.abs(got.mif - mif).max() <= 1e-4 * np.abs(mif).max()
    assert got.top_probability == pytest.approx(want.top_probability,
                                                rel=1e-5)
