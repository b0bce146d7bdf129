"""Torch port, the redesigned stream kernels' host side.

* The level schedule of the level-parallel logged forward and adjoint:
  its plain executors (``stream_forward_levels_plain``,
  ``stream_backward_levels_plain``) are bit-equal to the sequential plain
  versions the kernels are held to, on the BDD slice's module, a spilled
  JAX-built program, a program whose ops overwrite their own arguments'
  slots and fixture trees, in f32 and f64; the gather-form gradient also
  matches ``jax.grad`` through the JAX package's tape and adjoint Pallas
  kernels (interpret mode) within 1e-5 relative plus 1e-7 absolute, the
  tolerance of ``tests/test_torch_adjoint.py`` (f32, FMA contraction on
  the XLA side).
* The stream kernel's packed records round-trip to the op table, and
  their mux steps hold no read of a value written in the same step.
* ``stream_variant`` picks the step kernel for mux programs and the
  one-trial-per-thread kernel for the others.
* The batched BDD schedule evaluates bit-equal to the depth-first one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.schedule import build_stream_schedule
from canopy_tpu.ops import stream_kernel as jsk
from canopy_tpu.ops.adjoint_kernel import (compile_adjoint,
                                           make_differentiable_stream)
from canopy_tpu_torch.compiler.modules import build_modular_bdd
from canopy_tpu_torch.compiler.schedule import StreamProgram
from canopy_tpu_torch.ops import adjoint_kernel as tak
from canopy_tpu_torch.ops import stream_kernel as tsk

from test_adjoint import connective_tree
from test_stream_kernel import mixed_tree
from torch_parity import load_tree, overwriting_program

_CASES: dict = {}


def case(name: str):
    """(encoded program, house, JAX StreamProgram or None) by name."""
    if name not in _CASES:
        jprog = None
        if name == "slice-module":
            _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                                 tree_name="slice")
            bdd = max(build_modular_bdd(tree).chain,
                      key=lambda c: c[0].n_nodes)[0]
            enc, house = tsk.bdd_stream_encoding(bdd), []
        elif name == "overwriting":
            enc, house = tsk.encode_stream(overwriting_program(
                StreamProgram)), []
        elif name == "mixed-spilled":
            tree = mixed_tree()
            jprog = build_stream_schedule(tree, chunk_tiles=2, n_bufs=2)
            enc, house = tsk.encode_stream(jprog), tree.house_state_vector()
        elif name == "connective":
            tree = connective_tree()
            jprog = jsk.compile_stream(tree, chunk_tiles=2)
            enc, house = tsk.encode_stream(jprog), tree.house_state_vector()
        else:
            _m, tree = load_tree("canopy_tpu_torch", name)
            enc, house = tsk.tree_stream_encoding(tree), \
                tree.house_state_vector()
        _CASES[name] = (enc, house, jprog)
    return _CASES[name]


NAMES = ["slice-module", "overwriting", "mixed-spilled", "connective",
         "aralia_like_ccf", "aralia_like_noncoherent"]


def _inputs(enc, n_trials: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    staged = torch.from_numpy(rng.uniform(0.0, 0.3, (enc.n_basic,
                                                     n_trials))).to(dtype)
    ct = torch.from_numpy(rng.uniform(0.5, 1.5, n_trials)).to(dtype)
    return staged, ct


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_level_executors_are_bit_equal_to_plain(name, dtype):
    enc, house, _j = case(name)
    h = tsk.house_tensor(enc, house, "cpu", dtype)
    for n_trials in (1, 16):
        staged, ct = _inputs(enc, n_trials, dtype, seed=n_trials)
        top, log = tsk.stream_forward_plain(enc, staged, h, with_log=True)
        ltop, llog = tsk.stream_forward_levels_plain(enc, staged, h)
        assert torch.equal(ltop, top) and torch.equal(llog, log)
        grad = tak.stream_backward_plain(enc, staged, h, log, ct)
        lgrad = tak.stream_backward_levels_plain(enc, staged, h, log, ct)
        assert torch.equal(lgrad, grad), name


@pytest.mark.parametrize("name", ["mixed-spilled", "connective"])
def test_level_gradient_matches_jax_adjoint_kernel(name):
    """The gather-form gradient against jax.grad through the JAX tape
    and adjoint kernels on the same program and input (f32)."""
    enc, house, jprog = case(name)
    basic = np.random.default_rng(11).uniform(
        0.0, 1.0, (1024, jprog.n_basic)).astype(np.float32)
    f = make_differentiable_stream(compile_adjoint(jprog), house,
                                   interpret=True)
    want = np.asarray(jax.grad(
        lambda bp: f(jsk.stage_basic(jprog, bp)).sum())(jnp.asarray(basic)))
    t = torch.from_numpy(basic)
    staged = tsk.stage_basic(enc, t)
    h = tsk.house_tensor(enc, house, "cpu")
    _top, log = tsk.stream_forward_levels_plain(enc, staged, h)
    g = tak.stream_backward_levels_plain(enc, staged, h, log,
                                         torch.ones(1024))
    got = tsk.unstage_basic(enc, g, jprog.n_basic).T.numpy()
    np.testing.assert_allclose(got.T, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", NAMES)
def test_level_schedule_invariants(name):
    enc, _house, _j = case(name)
    sched = tsk.level_schedule(enc)
    assert sched is tsk.level_schedule(enc)
    ops, args = enc.ops, enc.args
    level = np.empty(len(ops), dtype=np.int64)
    for lv in range(sched.n_levels):
        level[sched.order[sched.level_ptr[lv]:sched.level_ptr[lv + 1]]] = lv
    assert sorted(sched.order.tolist()) == list(range(len(ops)))
    op_of = np.repeat(np.arange(len(ops)), ops[:, 3] - ops[:, 2])
    seen = np.zeros(len(args), dtype=np.int64)
    for o in range(len(ops)):
        edges = sched.cons[sched.cons_ptr[o]:sched.cons_ptr[o + 1]]
        seen[edges] += 1
        # Consumers sit above their producer, op descending, then row.
        assert np.all(level[op_of[edges]] > level[o])
        keys = list(zip(-op_of[edges], edges))
        assert keys == sorted(keys)
    for r in range(enc.n_basic):
        edges = sched.stage_cons[sched.stage_ptr[r]:sched.stage_ptr[r + 1]]
        seen[edges] += 1
        assert np.all(args[edges, 0] == tsk.STAGED)
        assert np.all(args[edges, 1] == r)
    # Every pool or staged read is one edge of exactly one list.
    np.testing.assert_array_equal(seen, args[:, 0] != tsk.HOUSE)
    writers = [o for o in range(len(ops)) if ops[o, 1] == enc.top_slot]
    assert sched.top_op == writers[-1]


def unpack_records(recs: np.ndarray, rec_op: np.ndarray,
                   pool_slots: int) -> list:
    """Decode ``pack_records``' output back into ``(op, kind, out,
    fields)`` tuples in record order, padding (NOPs, muxes into the
    scratch row ``pool_slots``) dropped."""
    out = []
    for r, o in zip(recs.tolist(), rec_op.tolist()):
        kind, slot = r[0] >> 24, r[0] & 0xFFFFFF
        if kind == tsk.R_NOP or (kind == tsk.R_MUX and slot == pool_slots):
            assert o == -1
            continue
        out.append((o, kind, slot, tuple(r[1:])))
    return out


@pytest.mark.parametrize("step", [8, 4, 2])
@pytest.mark.parametrize("name", ["slice-module", "overwriting",
                                  "mixed-spilled", "aralia_like_ccf"])
def test_records_round_trip(name, step):
    enc, _house, _j = case(name)
    recs, rec_op = tsk.pack_records(enc, step)
    assert recs.shape == (len(rec_op), 4) and len(recs) % tsk.REC_CHUNK == 0
    assert np.all(recs[-tsk.REC_CHUNK:] == 0)      # the prefetch's NOPs
    decoded = unpack_records(recs, rec_op, enc.pool_slots)
    assert [o for o, *_ in decoded] == list(range(enc.n_ops))
    for o, kind, out, fields in decoded:
        op = enc.ops[o]
        assert out == op[1]
        a = enc.args[op[2]:op[3]]
        fast = op[0] == tsk.MUX and list(a[:, 0]) == [
            tsk.STAGED, tsk.POOL, tsk.POOL] and not a[:, 2].any()
        assert kind == (tsk.R_MUX if fast else tsk.R_OP)
        if fast:
            assert fields == tuple(a[:, 1])
    # Steps: all muxes (padding into the scratch row) or general ops; no
    # mux reads a slot that another mux of its step writes.
    for first in range(0, len(recs) - tsk.REC_CHUNK, step):
        block = recs[first:first + step]
        kinds = set(block[:, 0] >> 24)
        assert kinds <= {tsk.R_MUX} or kinds <= {tsk.R_OP, tsk.R_NOP}
        if kinds == {tsk.R_MUX}:
            written: set = set()
            for rec in block.tolist():
                assert not written & set(rec[2:])
                written.add(rec[0] & 0xFFFFFF)
                written.discard(enc.pool_slots)     # the scratch row


def test_batched_module_fills_its_steps():
    """The slice module's batched schedule packs into steps of 8 at least
    95 % full (its depth-first order: about 14 %)."""
    enc, _house, _j = case("slice-module")
    _recs, rec_op = tsk.pack_records(enc, 8)
    assert (rec_op >= 0).sum() / (len(rec_op) - tsk.REC_CHUNK) >= 0.95


def test_batched_bdd_schedule_is_bit_equal_to_depth_first():
    """Each mux keeps its own arithmetic, so the batched order gives the
    depth-first order's values bit for bit, in no more pool slots."""
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    bdd = max(build_modular_bdd(tree).chain, key=lambda c: c[0].n_nodes)[0]
    dfs = tsk.encode_stream(tsk.compile_bdd_stream(bdd))
    batched = tsk.encode_stream(tsk.compile_bdd_stream(bdd, batch=8))
    assert batched.n_ops == dfs.n_ops
    assert batched.pool_slots <= dfs.pool_slots
    values = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 0.3, (64, int(dfs.staged_cols.max()) + 1)))
    got, want = (tsk.stream_forward_plain(
        e, tsk.stage_basic(e, values, torch.float64),
        tsk.house_tensor(e, [], "cpu", torch.float64))[0]
        for e in (batched, dfs))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_stream_variant(name):
    """Programs of muxes and fills (the BDD module) run the step kernel;
    programs with products, pairs, counts or spills the
    one-trial-per-thread kernel."""
    enc, _h, _j = case(name)
    want = "steps" if name == "slice-module" else "ops"
    assert tsk.stream_variant(enc) == want


def test_level_tile():
    assert [tsk.level_tile(n) for n in (1, 132, 133, 1024, 1 << 20)] == \
        [1, 1, 2, 8, 32]
