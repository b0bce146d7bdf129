"""Torch port, the replay engine on the CPU: encoder, plain forward, staging.

The same numpy inputs go through the JAX package and the port; both build
their replay programs with the same (vendored) builder, so the programs'
op lists are compared first.  Tolerances:

* the port's plain forward against the JAX replay kernel in interpret
  mode, against the JAX float32 gather engine and against both host
  simulators (the JAX package's and the vendored one): bit-equal on the
  prod/pair trees, where every engine runs the same float32 operations
  in the same order; within 1e-6 relative on trees with count and xor
  gates against XLA (which may contract a multiply and an add into one
  rounding), still bit-equal against the simulators;
* ``make_propagator(engine="replay")`` against the JAX f64 gather engine:
  within 1e-6 relative plus 2^-24 absolute (float32 rounds each
  ``1 - p`` of an OR to an absolute half ulp of 1.0);
* staging: round trips exact; the adjoint identity
  ``<stage(p), g> == <p, replay_grad_basic(g)>`` within 1e-12 in f64;
  ``replay_grad_basic`` bit-equal to a numpy scatter-add in stream order
  and within 1e-6 relative of the JAX one (whose scatter order is XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.replay import build_replay_schedule as jax_build
from canopy_tpu.compiler.replay import \
    simulate_replay_program as jax_simulate
from canopy_tpu.engine.propagate import \
    top_event_probability as jax_top_probability
from canopy_tpu.ops import stream_kernel as jsk
from canopy_tpu.utils.synthetic import \
    synthetic_compiled_tree as jax_synthetic
from canopy_tpu_torch.compiler.replay import (build_replay_schedule,
                                              simulate_replay_program)
from canopy_tpu_torch.engine.propagate import (make_propagator,
                                               make_staged_propagator)
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import stream_kernel as tsk
from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree

from torch_parity import load_tree, walk_ring

#: The JAX tests' thrash-shaped schedule (tests/test_replay.py): a tiny
#: pool and short segments force evictions, slab reads, gate-stream reads
#: and refills on trees small enough for interpret mode.
THRASH = dict(brs_chunk=16, brs_bufs=3, grs_chunk=8, grs_bufs=2,
              slab_bufs=3, slab_tiles=8, max_ops_per_segment=150,
              pool_slots=12, hoist_events=8, n_refill_sems=4,
              n_flush_sems=2)
TREE = dict(n_basic=96, n_gates=900, fanin=4, n_levels=10)
#: Float32 engines against f64: relative, plus 2^-24 absolute.
F32_RTOL, F32_ATOL = 1e-6, 2.0 ** -24


def both(seed=0, **config):
    """(JAX program, port program, JAX tree) of the synthetic tree."""
    jtree = jax_synthetic(seed=seed, **TREE)
    tree = synthetic_compiled_tree(seed=seed, **TREE)
    return jax_build(jtree, **config), build_replay_schedule(tree, **config), \
        jtree


def uniform(shape, seed, hi=0.3):
    return np.random.default_rng(seed).uniform(0.0, hi, shape) \
        .astype(np.float32)


def plain_tops(program, p: np.ndarray, house=()) -> np.ndarray:
    enc = tsk.encode_replay(program)
    return tsk.replay_propagate(enc, torch.from_numpy(p), house).numpy()


def jax_f32_gather(tree, p: np.ndarray, house) -> np.ndarray:
    """The JAX f32 gather engine, run eagerly (op by op, as the JAX
    package's replay tests run it: no fused multiply-adds)."""
    return np.asarray(jax_top_probability(
        tree, jnp.asarray(p), jnp.asarray(house, jnp.float32)))


def test_programs_equal_the_jax_builders():
    jprog, prog, _tree = both(**THRASH)
    assert prog.segments == jprog.segments
    np.testing.assert_array_equal(prog.brs_cols, jprog.brs_cols)
    for a, b in zip(prog.grs_rows, jprog.grs_rows, strict=True):
        np.testing.assert_array_equal(a, b)
    assert (prog.n_evicted, prog.n_intra, prog.n_inter, prog.n_slab_reads,
            prog.top_slot) == (jprog.n_evicted, jprog.n_intra,
                               jprog.n_inter, jprog.n_slab_reads,
                               jprog.top_slot)


def test_forward_matches_jax_interpret_kernel():
    """The JAX replay kernel (Pallas, interpret mode) as
    ``tests/test_replay.py`` runs it: bit-equal."""
    jprog, prog, _tree = both(**THRASH)
    assert prog.n_evicted and prog.n_intra and prog.n_inter \
        and prog.n_slab_reads
    p = uniform((1024, TREE["n_basic"]), 0)
    want = np.asarray(jsk.replay_propagate(jprog, jnp.asarray(p),
                                           np.zeros(0, np.float32),
                                           interpret=True))
    np.testing.assert_array_equal(plain_tops(prog, p), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_matches_simulators_and_gather(seed):
    jprog, prog, tree = both(seed=seed, **THRASH)
    p = uniform((64, tree.n_basic), seed)
    got = plain_tops(prog, p)
    np.testing.assert_array_equal(got, jax_f32_gather(tree, p, []))
    for i in range(3):
        assert got[i] == simulate_replay_program(prog, p[i], np.zeros(0))
        assert got[i] == jax_simulate(jprog, p[i], np.zeros(0))


def test_random_schedule_configs():
    """The JAX package's randomized schedule sweep, plain against the
    vendored simulator and the f32 gather, bit-equal."""
    rng = np.random.default_rng(11)
    n_ok = 0
    for _trial in range(8):
        seed = int(rng.integers(0, 1000))
        tree = synthetic_compiled_tree(
            n_basic=96, n_gates=int(rng.choice([300, 900])), fanin=4,
            n_levels=int(rng.choice([6, 10])), seed=seed)
        config = dict(
            brs_chunk=int(rng.choice([8, 16, 32])), brs_bufs=3,
            grs_chunk=int(rng.choice([8, 16])), grs_bufs=2,
            slab_bufs=int(rng.choice([2, 3, 4])),
            slab_tiles=int(rng.choice([2, 4, 8])),
            max_ops_per_segment=int(rng.choice([40, 150, 5000])),
            pool_slots=int(rng.choice([7, 12, 24])),
            hoist_events=int(rng.choice([0, 8])),
            resident_tiles=int(rng.choice([0, 8])),
            n_refill_sems=4, n_flush_sems=2)
        try:
            program = build_replay_schedule(tree, **config)
        except LogicError:
            continue
        p = uniform((16, tree.n_basic), seed)
        got = plain_tops(program, p)
        want = make_propagator(tree, "cpu", engine="gather")(
            torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == simulate_replay_program(program, p[0], np.zeros(0))
        n_ok += 1
    assert n_ok >= 4


@pytest.mark.parametrize("resident", [4, 16, 64])
def test_resident_tier(resident):
    jprog, prog, tree = both(resident_tiles=resident, **THRASH)
    assert prog.res_tiles and prog.n_resident_reads
    enc = tsk.encode_replay(prog)
    assert enc.res_rows == prog.res_tiles
    p = uniform((64, tree.n_basic), resident)
    got = plain_tops(prog, p)
    np.testing.assert_array_equal(got, jax_f32_gather(tree, p, []))
    assert got[0] == jax_simulate(jprog, p[0], np.zeros(0))


def test_house_events():
    """The JAX tests' mixed tree (house events, complements, pair and
    count gates) through the JAX builder, encoded by the port; and the
    ``demo_plant`` fixture through both builders."""
    from test_stream_kernel import mixed_tree
    config = dict(brs_chunk=4, brs_bufs=3, grs_chunk=8, grs_bufs=2,
                  slab_bufs=2, slab_tiles=2, max_ops_per_segment=3,
                  pool_slots=8, hoist_events=4, n_refill_sems=4,
                  n_flush_sems=2)
    jtree = mixed_tree(n_house=2)
    jprog = jax_build(jtree, **config)
    house = jtree.house_state_vector()
    p = uniform((256, jtree.n_basic), 2, hi=0.5)
    got = plain_tops(jprog, p, house)
    np.testing.assert_allclose(got, jax_f32_gather(jtree, p, house),
                               rtol=F32_RTOL, atol=0)
    for i in range(3):
        assert got[i] == jax_simulate(jprog, p[i], house)
    _jm, jtree = load_tree("canopy_tpu", "demo_plant", tree_name="Cooling")
    _tm, tree = load_tree("canopy_tpu_torch", "demo_plant",
                          tree_name="Cooling")
    program = build_replay_schedule(tree, **config)
    assert program.segments == jax_build(jtree, **config).segments
    house = tree.house_state_vector()
    assert len(house)
    p = uniform((256, tree.n_basic), 3, hi=0.5)
    got = plain_tops(program, p, house)
    np.testing.assert_allclose(got, jax_f32_gather(jtree, p, house),
                               rtol=F32_RTOL, atol=0)
    assert got[0] == simulate_replay_program(program, p[0], house)


def test_ccf_fixture_through_replay():
    """XML -> initializer -> CCF expansion -> compile -> replay, as the
    JAX package's full-stack test: against the JAX f32 gather and the
    simulator."""
    _jm, jtree = load_tree("canopy_tpu", "aralia_like_ccf")
    _tm, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    config = dict(brs_chunk=64, brs_bufs=3, grs_chunk=64, grs_bufs=2,
                  slab_bufs=2, slab_tiles=4, max_ops_per_segment=60,
                  pool_slots=40, hoist_events=4, n_refill_sems=4,
                  n_flush_sems=2)
    program = build_replay_schedule(tree, **config)
    assert program.segments == jax_build(jtree, **config).segments
    house = tree.house_state_vector()
    p = uniform((512, tree.n_basic), 6)
    got = plain_tops(program, p, house)
    np.testing.assert_allclose(got, jax_f32_gather(jtree, p, house),
                               rtol=F32_RTOL, atol=0)
    assert got[0] == simulate_replay_program(program, p[0], house)


def test_encoder_resolves_log_rows():
    """Every slab, gate-stream and refill read names the eviction-log row
    the TPU schedule read it from (``trace``), every basic-stream read a
    row of its own basic, and every value source the gate that made it."""
    _jprog, prog, _tree = both(resident_tiles=16, **THRASH)
    enc = tsk.encode_replay(prog)
    P, R = prog.pool_slots, prog.res_tiles
    gate_ops = enc.ops[enc.ops[:, 0] < tsk.EVICT]
    refills = enc.ops[enc.ops[:, 0] == tsk.REFILL]
    assert [int(r[4]) for r in refills] == \
        [rec["evict_event"] for rec in prog.trace["refills"]]
    assert (enc.ops[enc.ops[:, 0] == tsk.EVICT][:, 4]
            == np.arange(prog.n_evicted)).all()
    seen = set()
    for g, rec in enumerate(prog.trace["gates"]):
        _kind, _out, b, e, _a0, _a1, row = gate_ops[g]
        assert row == g and e - b == len(rec["args"])
        for (loc, flag), arg in zip(rec["args"], enc.args[b:e]):
            assert arg[2] == int(bool(flag))
            where = loc[0]
            if where == "slab":
                e_row = loc[1]
            elif where == "grs":
                e_row = int(prog.grs_rows[loc[1]][loc[2]]) - P
            else:
                e_row = None
            if e_row is not None:
                assert (arg[0], arg[1]) == (tsk.POOL, P + R + e_row)
                seen.add(where)
            elif where == "brs":
                assert arg[0] == tsk.STAGED
            elif where == "rbas":
                assert (arg[0], arg[1]) == (tsk.POOL, P + loc[1])
    assert seen == {"slab", "grs"}
    # Basic-stream rows: one per read, each read once, the rest padding.
    stream_rows = enc.args[enc.args[:, 0] == tsk.STAGED][:, 1]
    assert len(set(stream_rows.tolist())) == len(stream_rows) == sum(
        loc[0] == "brs" for rec in prog.trace["gates"]
        for loc, _f in rec["args"])
    # Value sources: a gate's output row, a staged row or a house value.
    assert set(enc.args[:, 3].tolist()) <= {tsk.LOG, tsk.STAGED}
    assert enc.args[enc.args[:, 3] == tsk.LOG][:, 4].max() < enc.n_log


def test_staging_round_trips():
    _jprog, prog, tree = both(resident_tiles=16, **THRASH)
    enc = tsk.encode_replay(prog)
    p = torch.from_numpy(uniform((50, tree.n_basic), 3)).double()
    staged = tsk.stage_replay(enc, p, torch.float64)
    assert staged.shape == (prog.brs_len_pad, 50)
    read = np.unique(enc.staged_cols[enc.read_rows])
    back = tsk.unstage_replay(enc, staged)
    assert torch.equal(back[:, read], p[:, read])
    assert not back[:, np.setdiff1d(np.arange(tree.n_basic), read)].any()
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=staged.shape))
    g[np.setdiff1d(np.arange(prog.brs_len_pad), enc.read_rows)] = 0.0
    lhs = float((staged * g).sum())
    rhs = float((p * tsk.replay_grad_basic(enc, g)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    with pytest.raises(LogicError):
        tsk.stage_replay(enc, p[:, :-1])


def test_grad_basic_order_and_jax_parity():
    jprog, prog, tree = both(**THRASH)
    enc = tsk.encode_replay(prog)
    g = np.random.default_rng(5).normal(
        size=(prog.brs_len_pad, 1024)).astype(np.float32)
    g[np.setdiff1d(np.arange(prog.brs_len_pad), enc.read_rows)] = 0.0
    got = tsk.replay_grad_basic(enc, torch.from_numpy(g)).numpy()
    # A numpy scatter-add, row after row in stream order.
    want = np.zeros((tree.n_basic, 1024), np.float32)
    np.add.at(want, prog.brs_cols[enc.read_rows], g[enc.read_rows])
    np.testing.assert_array_equal(got, want.T)
    jax_g = np.asarray(jsk.replay_grad_basic(
        jprog, jnp.asarray(g.reshape(prog.brs_len_pad, 8, 128)), 1024))
    np.testing.assert_allclose(got, jax_g, rtol=1e-6, atol=1e-6)


def test_sizing_reads_the_built_program():
    """Default sizing: 56 pool slots (two 256-trial blocks share an SM),
    no resident tier, widened for a gate wider than the pool.  The
    shared-memory check reads the program as built: a resident request
    of 128 padded up to the 256-row basic-stream chunk makes 256 resident
    slots, so a pool of ``REPLAY_SLOTS`` - 128 no longer fits.
    ``REPLAY_SLOTS``: one warp's block beside the op-stream chunks and the
    shallowest ring."""
    tree = synthetic_compiled_tree(seed=0, **TREE)
    assert tsk.REPLAY_SLOTS == 1743 == (
        tsk.SMEM_BYTES - 16 - 8 * tsk.REPLAY_CHUNK_WORDS) // (32 * 4) - 8
    program = tsk.compile_replay_stream(tree)
    assert (program.pool_slots, program.res_tiles) == (56, 0)
    assert tsk.SMEM_BYTES // (4 * tsk.REPLAY_TRIALS) == 56
    with pytest.raises(LogicError, match="resident"):
        tsk.compile_replay_stream(tree, resident_tiles=128,
                                  pool_slots=tsk.REPLAY_SLOTS - 128)
    fits = tsk.compile_replay_stream(tree, resident_tiles=128,
                                     pool_slots=tsk.REPLAY_SLOTS - 128,
                                     brs_chunk=128)
    assert fits.res_tiles == 128
    from test_torch_propagator import wide_tree
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    from canopy_tpu_torch.mef.expr.constant import ConstantExpression
    wide = wide_tree(compile_gates, BasicEvent, Gate, Arg, Formula,
                     Connective, ConstantExpression)
    # An 800-way OR: the pool widens to its working set; the schedule's
    # ring window (3 x 256 rows) then refuses it, as in the JAX package.
    assert tsk._replay_sizing(wide, {})["pool_slots"] == 802
    with pytest.raises(LogicError, match="ring window"):
        tsk.compile_replay_stream(wide)


def test_make_propagator_replay_engine():
    _jm, jtree = load_tree("canopy_tpu", "aralia_like_noncoherent")
    _tm, tree = load_tree("canopy_tpu_torch", "aralia_like_noncoherent")
    rng = np.random.default_rng(7)
    p = np.exp(rng.uniform(np.log(1e-3), np.log(0.2), (200, tree.n_basic)))
    want = np.asarray(jax.jit(lambda q: jax_top_probability(jtree, q))(
        jnp.asarray(p)))
    fn = make_propagator(tree, "cpu", engine="replay")
    assert fn.engine == "replay"
    got = fn(torch.from_numpy(p)).double().numpy()
    assert np.all(np.abs(got - want) <= F32_RTOL * np.abs(want) + F32_ATOL)
    stage, run = make_staged_propagator(tree, "cpu", engine="replay")
    assert run.engine == "replay"
    assert torch.equal(run(stage(torch.from_numpy(p))),
                       fn(torch.from_numpy(p)))
    with pytest.raises(ValueError):
        fn(torch.from_numpy(p), torch.ones(max(tree.n_house, 1)))
    with pytest.raises(ValueError):
        make_propagator(tree, "cpu", output="all", engine="replay")
    # On CUDA (decided without a card) auto keeps the stream.
    assert make_propagator(tree, torch.device("cuda")).engine == "stream"


# ---------------------------------------------------------------------------
# The ring kernel's host plan and op stream (csrc/replay_ops.cuh).
# ---------------------------------------------------------------------------

#: A seven-slot schedule that reads rows of the eviction log back within
#: a few ring entries of their EVICT: its ring needs pads at every depth.
PADS = dict(THRASH, grs_chunk=16, slab_bufs=2, slab_tiles=2,
            max_ops_per_segment=5000, pool_slots=7)


def wide_count_tree():
    """AND of cardinality [130, 140] over 300 basic events (every fifth
    complemented: 142 DP states) and cardinality [0, 12] of 12 of them
    (always true: its DP reads no argument): gates past the kernel's narrow
    path, one of which reads nothing."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    from canopy_tpu_torch.mef.expr.constant import ConstantExpression
    events = []
    for i in range(300):
        e = BasicEvent(f"c{i:03d}")
        e.expression = ConstantExpression(0.4)
        events.append(e)
    wide, always, top = Gate("wide"), Gate("always"), Gate("top")
    wide.formula = Formula(Connective.CARDINALITY,
                           [Arg(e, complement=i % 5 == 4)
                            for i, e in enumerate(events)],
                           min_number=130, max_number=140)
    always.formula = Formula(Connective.CARDINALITY,
                             [Arg(e) for e in events[:12]], min_number=0,
                             max_number=12)
    top.formula = Formula(Connective.AND, [Arg(wide), Arg(always)])
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def ring_cases():
    """(label, encoded program, inputs) of programs with every read kind:
    the thrash schedule, one whose log reads follow their evictions
    closely (pads), a resident tier, a house/pair/count tree and wide
    count gates."""
    from test_stream_kernel import mixed_tree
    cases = []
    _j, prog, tree = both(**THRASH)
    cases.append(("thrash", tsk.encode_replay(prog),
                  uniform((16, tree.n_basic), 0), ()))
    tree = synthetic_compiled_tree(n_basic=96, n_gates=300, fanin=4,
                                   n_levels=10, seed=107)
    cases.append(("pads", tsk.encode_replay(build_replay_schedule(
        tree, **PADS)), uniform((16, tree.n_basic), 3), ()))
    _j, prog, tree = both(resident_tiles=16, **THRASH)
    cases.append(("resident", tsk.encode_replay(prog),
                  uniform((16, tree.n_basic), 1), ()))
    jtree = mixed_tree(n_house=2)
    config = dict(brs_chunk=4, brs_bufs=3, grs_chunk=8, grs_bufs=2,
                  slab_bufs=2, slab_tiles=2, max_ops_per_segment=3,
                  pool_slots=8, hoist_events=4, n_refill_sems=4,
                  n_flush_sems=2)
    cases.append(("mixed", tsk.encode_replay(jax_build(jtree, **config)),
                  uniform((16, jtree.n_basic), 2, hi=0.5),
                  jtree.house_state_vector()))
    tree = wide_count_tree()
    p = np.random.default_rng(4).uniform(0.35, 0.55, (4, tree.n_basic))
    cases.append(("wide", tsk.encode_replay(tsk.compile_replay_stream(
        tree, grs_chunk=512)), p.astype(np.float32), ()))
    return cases


@pytest.mark.parametrize("depth", tsk.REPLAY_RING_DEPTHS)
def test_ring_walk_equals_plain(depth):
    """The kernel's walk of :func:`replay_ring_stream` (every ring depth
    it is built for) is bit-equal to ``replay_forward_plain``, value log
    included, on every read kind; no eviction-log row is fetched before
    its EVICT."""
    for label, enc, p, house in ring_cases():
        ring = tsk.replay_ring_stream(enc, depth)
        staged = tsk.stage_replay(enc, torch.from_numpy(p))
        h = tsk.house_tensor(enc, house, "cpu")
        top, vlog = walk_ring(enc, ring, staged, h, True)
        want_top, want_log = tsk.replay_forward_plain(enc, staged, h, True)
        assert torch.equal(top, want_top), (label, depth)
        assert torch.equal(vlog, want_log), (label, depth)


def test_ring_stream_reads_the_program_in_order():
    """The ring's fetch list is the program's reads in order: each
    basic-stream argument's row, each eviction-log argument's row and each
    REFILL's row (the refill prefetch list), with pads (fetching nothing)
    only where a read follows its EVICT by fewer than ``depth - 1``
    entries; every op fits its chunk, and the headers carry each gate's
    ring reads and each REFILL's fetch."""
    _label, enc, _p, _h = ring_cases()[1]
    assert enc.n_evicted and (enc.ops[:, 0] == tsk.REFILL).any()
    shared_rows = enc.pool_slots + enc.res_rows
    want, refills = [], []
    for kind, _slot, b, e, aux0, _a1, _row in enc.ops.tolist():
        if kind == tsk.REFILL:
            want.append(tsk._RING_EVLOG + aux0)
            refills.append(want[-1])
        elif kind != tsk.EVICT:
            for src, idx, *_r in enc.args[b:e].tolist():
                if src == tsk.STAGED:
                    want.append(idx + 1)
                elif src == tsk.POOL and idx >= shared_rows:
                    want.append(tsk._RING_EVLOG + idx - shared_rows)
    for depth in tsk.REPLAY_RING_DEPTHS:
        ring = tsk.replay_ring_stream(enc, depth)
        fetches = ring.fetches.tolist()
        assert [f for f in fetches if f] == want
        assert fetches.count(0) == ring.n_pads
        staged_rows = [f - 1 for f in want if f < tsk._RING_EVLOG]
        assert staged_rows == sorted(set(staged_rows))
        words = ring.words.reshape(ring.n_chunks, ring.chunk_words)
        got_refills = []
        for chunk in words.tolist():
            w = 0
            while chunk[w] >= 0:
                kind, b, e, extra = chunk[w], chunk[w + 2], chunk[w + 3], \
                    chunk[w + 7]
                assert b == w + 8 and e < ring.chunk_words
                if kind == tsk.REFILL:
                    got_refills.append(extra)
                elif kind != tsk.EVICT:
                    assert extra == sum((x & 0xFFFFFFFF) >> 30 == tsk._W_RING
                                        for x in chunk[b:e])
                w = e
        # Each REFILL issues the entry depth - 1 ahead of its own.
        at = [i for i, f in enumerate(fetches) if f in set(refills)]
        assert len(at) == len(refills)
        padded = fetches + [0] * depth
        assert got_refills == [padded[i + depth - 1] for i in at]
        assert ring.n_pads > 0


def test_ring_plan_derives_from_the_program():
    """Block width and ring depth come from ``pool_slots + res_rows``:
    the ring is the shallowest depth whose rows hold
    ``REPLAY_RING_BYTES`` (else the deepest), the block the widest power
    of two that fits shared memory with its ring and spreads the trials
    over 132 SMs (below a warp only where a warp does not fit, as 1,200
    float64 slots); more slots, narrower blocks."""
    tree = synthetic_compiled_tree(seed=0, **TREE)
    depths = tsk.REPLAY_RING_DEPTHS

    def ring_for(width, s):
        return next((d for d in depths
                     if d * width * s >= tsk.REPLAY_RING_BYTES), depths[-1])
    widths = {}
    for pool in (12, 113, 400, 1200):
        enc = tsk.encode_replay(tsk.compile_replay_stream(
            tree, pool_slots=pool))
        slots = enc.pool_slots + enc.res_rows
        for dtype, s in ((torch.float32, 4), (torch.float64, 8)):
            for n_trials in (1, 1024, 65_536):
                plan = tsk.replay_plan(enc, dtype, n_trials)

                def shared(width, depth):
                    return 16 + 8 * plan.chunk_words + \
                        (slots + depth) * width * s
                assert plan.shared_bytes == shared(plan.width, plan.depth)
                assert plan.shared_bytes <= tsk.SMEM_BYTES
                assert plan.depth == max(
                    d for d in depths if d <= ring_for(plan.width, s)
                    and shared(plan.width, d) <= tsk.SMEM_BYTES)
                spread = max(32, 1 << (-(-n_trials // 132)).bit_length() - 1)
                assert plan.width & (plan.width - 1) == 0
                assert plan.width <= spread
                wider = 2 * plan.width
                assert wider > spread or wider > 1024 or \
                    shared(wider, ring_for(wider, s)) > tsk.SMEM_BYTES
                widths[pool, s, n_trials] = plan.width
    assert widths[12, 4, 65_536] >= widths[113, 4, 65_536] \
        >= widths[400, 4, 65_536] >= widths[1200, 4, 65_536]
    enc = tsk.encode_replay(tsk.compile_replay_stream(tree))
    assert enc.pool_slots == 56
    for dtype, n_trials, shape in ((torch.float32, 65_536, (256, 32)),
                                   (torch.float64, 65_536, (256, 16)),
                                   (torch.float32, 1024, (32, 64)),
                                   (torch.float64, 1, (32, 64))):
        plan = tsk.replay_plan(enc, dtype, n_trials)
        assert (plan.width, plan.depth) == shape
