"""Torch port, the spill engine on the CPU: schedule, encoder, plain
forward, ``make_propagator(engine="spill")``.

Both packages build spill programs with the same (vendored) builder, so
the programs are compared op for op first.  Tolerances:

* the port's plain forward against the JAX spill kernel in interpret mode
  (``tests/test_spill.py``'s runs): within 1e-6 relative plus 1e-7
  absolute, the JAX tests' own band (interpret-mode contraction may round
  differently); against the port's float32 gather engine and the
  vendored host simulator: bit-equal (same float32 operations in the same
  order);
* ``make_propagator(engine="spill")`` against the f64 gather engine:
  within 1e-5 relative plus 2^-24 absolute (float32 rounds each ``1 - p``
  of an OR to an absolute half ulp of 1.0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.graph import compile_gates
from canopy_tpu.compiler.spill import build_spill_schedule as jax_build
from canopy_tpu.engine.propagate import spill_auto_ok as jax_spill_auto_ok
from canopy_tpu.ops import stream_kernel as jsk
from canopy_tpu.utils.synthetic import \
    synthetic_compiled_tree as jax_synthetic
from canopy_tpu.utils.synthetic import (synthetic_hierarchical_tree,
                                        synthetic_mef_tree)
from canopy_tpu_torch.compiler.spill import (build_spill_schedule,
                                             simulate_spill_program)
from canopy_tpu_torch.engine.propagate import make_propagator, spill_auto_ok
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import stream_kernel as tsk

from test_stream_kernel import mixed_tree
from torch_parity import load_tree, walk_ring

F32_ATOL = 2.0 ** -24
TOP_RTOL = 1e-5


def mef_tree(**kwargs):
    top, _events = synthetic_mef_tree(**kwargs)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    return tree


def uniform(shape, seed, hi=1.0):
    return np.random.default_rng(seed).uniform(0.0, hi, shape) \
        .astype(np.float32)


def plain_tops(program, p: np.ndarray, house) -> np.ndarray:
    enc = tsk.encode_spill(program)
    return tsk.spill_propagate(enc, torch.from_numpy(p), house).numpy()


def gather_f32(tree, p: np.ndarray) -> np.ndarray:
    return make_propagator(tree, "cpu", engine="gather")(
        torch.from_numpy(p)).numpy()


#: ``tests/test_spill.py``'s trees and builder parameters.
SCHEDULES = [
    ("uniform-64", dict(n_basic=64, n_gates=256, fanin=4, n_levels=5, seed=1),
     dict(chunk_tiles=8, pool_slots=10, slab_tiles=4)),
    ("uniform-64-segments",
     dict(n_basic=64, n_gates=256, fanin=4, n_levels=5, seed=1),
     dict(chunk_tiles=8, pool_slots=12, slab_tiles=4,
          max_ops_per_segment=16)),
    ("uniform-96-a", dict(n_basic=96, n_gates=300, fanin=4, n_levels=6,
                          seed=2),
     dict(chunk_tiles=8, pool_slots=8, slab_tiles=2, hoist_events=0,
          n_refill_sems=3, n_flush_sems=2)),
    ("uniform-96-b", dict(n_basic=96, n_gates=300, fanin=4, n_levels=6,
                          seed=2),
     dict(chunk_tiles=8, pool_slots=12, slab_tiles=8, hoist_events=16,
          n_refill_sems=3, n_flush_sems=2)),
    ("uniform-96-c", dict(n_basic=96, n_gates=300, fanin=4, n_levels=6,
                          seed=2),
     dict(chunk_tiles=8, pool_slots=20, slab_tiles=8,
          max_ops_per_segment=25, hoist_events=6, n_refill_sems=3,
          n_flush_sems=2)),
    ("mef-counts", dict(n_basic=80, n_gates=60, fanin=4, seed=5,
                        atleast_fraction=0.25, complement_fraction=0.2),
     dict(chunk_tiles=4, pool_slots=32, slab_tiles=3, hoist_events=8)),
    ("mef-shared", dict(n_basic=50, n_gates=80, fanin=5, seed=11,
                        atleast_fraction=0.0, complement_fraction=0.0),
     dict(chunk_tiles=4, pool_slots=30, slab_tiles=2, hoist_events=4)),
    ("mixed", None, dict(chunk_tiles=2, pool_slots=8, slab_tiles=2,
                         hoist_events=6, n_refill_sems=3, n_flush_sems=2)),
]


def schedule_tree(config):
    if config is None:
        return mixed_tree()
    if "atleast_fraction" in config:
        return mef_tree(**config)
    return jax_synthetic(**config)


@pytest.mark.parametrize("label,config,params", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_equals_the_jax_builder(label, config, params):
    """Op for op, and the plain forward bit-equal to the float32 gather
    engine and to the vendored host simulator."""
    tree = schedule_tree(config)
    jprog = jax_build(tree, **params)
    prog = build_spill_schedule(tree, **params)
    assert prog.segments == jprog.segments
    np.testing.assert_array_equal(prog.basic_perm, jprog.basic_perm)
    for field in ("pool_slots", "scratch_rows", "top_slot", "n_ops",
                  "n_evicted", "n_refills", "n_chunks", "n_basic_pad"):
        assert getattr(prog, field) == getattr(jprog, field), field
    # Either package's program encodes to the same tables.
    enc, jenc = tsk.encode_spill(prog), tsk.encode_spill(jprog)
    np.testing.assert_array_equal(enc.ops, jenc.ops)
    np.testing.assert_array_equal(enc.args, jenc.args)
    assert enc.counts["evictions"] == prog.n_evicted
    assert enc.n_scratch == prog.scratch_rows - prog.pool_slots
    p = uniform((32, tree.n_basic), 3)
    house = tree.house_state_vector()
    got = plain_tops(prog, p, house)
    np.testing.assert_array_equal(got, gather_f32(tree, p))
    for i in range(2):
        assert got[i] == np.float32(simulate_spill_program(prog, p[i],
                                                           house))


@pytest.mark.parametrize("label,tree_fn,params", [
    ("mixed-house", lambda: mixed_tree(n_house=2),
     dict(chunk_tiles=2, pool_slots=8, slab_tiles=2, hoist_events=6,
          n_refill_sems=3, n_flush_sems=2)),
    ("counts-segments", lambda: mef_tree(n_basic=60, n_gates=45, fanin=4,
                                         seed=7, atleast_fraction=0.3,
                                         complement_fraction=0.1),
     dict(chunk_tiles=4, pool_slots=24, slab_tiles=4, hoist_events=12,
          max_ops_per_segment=20)),
])
def test_plain_matches_jax_interpret_kernel(label, tree_fn, params):
    """The JAX spill kernel (Pallas, interpret mode) as
    ``tests/test_spill.py`` runs it: a mixed tree with house events and
    every gate family, and a tree with count gates across segment
    boundaries with evictions and refills."""
    tree = tree_fn()
    prog = build_spill_schedule(tree, **params)
    enc = tsk.encode_spill(prog)
    if label == "counts-segments":
        assert len(prog.segments) > 1 and prog.n_evicted > 0
        assert enc.counts["scratch_refills"] > 0
    p = uniform((1024, tree.n_basic), 0, hi=0.9)
    house = tree.house_state_vector()
    want = np.asarray(jsk.spill_propagate(jax_build(tree, **params),
                                          jnp.asarray(p), house,
                                          interpret=True))
    got = plain_tops(prog, p, house)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_every_op_kind_encodes():
    """A forced small schedule with staging spills, evictions, refills
    from the staged input and from scratch, and segment boundaries."""
    tree = jax_synthetic(n_basic=96, n_gates=300, fanin=4, n_levels=6,
                         seed=2)
    prog = build_spill_schedule(tree, chunk_tiles=8, pool_slots=12,
                                slab_tiles=4, max_ops_per_segment=40,
                                hoist_events=6, n_refill_sems=3,
                                n_flush_sems=2)
    enc = tsk.encode_spill(prog)
    assert all(enc.counts.values()), enc.counts
    assert enc.counts["segments"] == len(prog.segments) > 1
    kinds = set(enc.ops[:, 0].tolist())
    assert {tsk.SPILL, tsk.EVICT, tsk.REFILL, tsk.PROD} <= kinds
    assert tsk.encode_spill(prog) is enc   # cached on the program
    # Every eviction stores to a row its flush named, each row once.
    rows = enc.ops[enc.ops[:, 0] == tsk.EVICT, 4]
    np.testing.assert_array_equal(np.sort(rows), np.arange(enc.n_scratch))


def test_refill_of_the_dump_region_is_refused():
    tree = jax_synthetic(n_basic=64, n_gates=256, fanin=4, n_levels=5,
                         seed=1)
    prog = build_spill_schedule(tree, chunk_tiles=8, pool_slots=10,
                                slab_tiles=4)
    for seg in prog.segments:
        for i, op in enumerate(seg):
            if op[0] == "rwait" and op[1] == 1:
                seg[i] = ("rwait", 1, prog.pool_slots - 1, op[3], op[4])
                with pytest.raises(LogicError, match="dump region"):
                    tsk.encode_spill(prog)
                return
    pytest.fail("no scratch refill in the schedule")


def test_card_sizing():
    """The default pool (``SPILL_TRIALS``, from the card's sweep) and the
    ring kernel's shape: ``replay_plan`` sizes a spill block from its
    pool alone (no resident tier); the widest pool is the ring kernel's
    ``REPLAY_SLOTS`` (a one-warp block fits it beside the shallowest
    ring), and one slot more is refused by the sizing (the wrapper checks
    it too, before any launch: ``tests/test_torch_gpu.py``)."""
    tree = jax_synthetic(n_basic=256, n_gates=2048, fanin=4, n_levels=8,
                         seed=3)
    prog = tsk.compile_spill_stream(tree)
    assert prog.pool_slots == tsk.SMEM_BYTES // (4 * tsk.SPILL_TRIALS)
    assert prog.n_chunks == 1     # every basic a staged row
    enc = tsk.encode_spill(prog)
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        plan = tsk.replay_plan(enc, dtype, 65_536)
        assert plan.shared_bytes == 16 + 8 * plan.chunk_words + (
            prog.pool_slots + plan.depth) * plan.width * size
        assert plan.shared_bytes <= tsk.SMEM_BYTES
    assert tsk.SPILL_SLOTS == tsk.REPLAY_SLOTS
    widest = tsk.encode_spill(tsk.compile_spill_stream(
        tree, pool_slots=tsk.SPILL_SLOTS))
    plan = tsk.replay_plan(widest, torch.float32, 65_536)
    assert plan.width <= 32 and plan.shared_bytes <= tsk.SMEM_BYTES
    # The plan narrows a block below a warp before it gives up.
    over = tsk.encode_spill(build_spill_schedule(
        tree, pool_slots=tsk.SMEM_BYTES // 4, chunk_tiles=tree.n_basic,
        vmem_budget=1 << 62))
    with pytest.raises(LogicError, match="shared memory"):
        tsk.replay_plan(over, torch.float32, 65_536)
    with pytest.raises(LogicError, match="shared memory"):
        tsk.compile_spill_stream(tree, pool_slots=tsk.SPILL_SLOTS + 1)
    with pytest.raises(LogicError, match="fan-in"):
        tsk.compile_spill_stream(mixed_tree(), pool_slots=3)


@pytest.mark.parametrize("fixture", ["demo_plant", "aralia_like_ccf",
                                     "aralia_like_nested_count"])
def test_spill_engine_matches_gather(fixture):
    """``make_propagator(engine="spill")`` on the CPU (the kernel's plain
    version) against the f64 gather engine, on trees with house events,
    CCF groups and deep count nesting."""
    tree_name = "Cooling" if fixture == "demo_plant" else fixture
    _m, tree = load_tree("canopy_tpu_torch", fixture, tree_name=tree_name)
    fn = make_propagator(tree, "cpu", engine="spill")
    assert fn.engine == "spill"
    p = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 0.3, (64, tree.n_basic)))
    got = fn(p.float()).double()
    want = make_propagator(tree, "cpu", engine="gather")(p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOP_RTOL,
                               atol=F32_ATOL)
    with pytest.raises(ValueError, match="bakes house states"):
        fn(p.float(), house_states=tree.house_state_vector())


def test_spill_engine_on_the_65k_shape():
    """A uniform tree whose live set overflows the 113-slot pool: the
    default sizing evicts and refills, and the tops stay bit-equal to the
    stream program's plain version (same gates, same order)."""
    tree = jax_synthetic(n_basic=512, n_gates=4096, fanin=4, n_levels=10,
                         seed=0)
    enc = tsk.encode_spill(tsk.compile_spill_stream(tree))
    assert enc.counts["evictions"] and enc.counts["scratch_refills"]
    p = torch.from_numpy(uniform((16, tree.n_basic), 5, hi=0.05))
    senc = tsk.tree_stream_encoding(tree)
    assert torch.equal(tsk.spill_propagate(enc, p, []),
                       tsk.stream_propagate(senc, p, []))


def test_spill_auto_ok_matches_jax():
    """The thrashing guard on ``tests/test_spill.py``'s two trees."""
    heavy = jax_synthetic(n_basic=2048, n_gates=16384, fanin=4, n_levels=12,
                          seed=0)
    mild = synthetic_hierarchical_tree(n_basic=4096, branching=8,
                                       share_fraction=0.1, n_shared=64,
                                       seed=0)
    for tree, params, verdict in (
            (heavy, dict(pool_slots=96, chunk_tiles=32, slab_tiles=16),
             False),
            (mild, dict(chunk_tiles=32), True)):
        prog = build_spill_schedule(tree, **params)
        jprog = jax_build(tree, **params)
        assert (prog.n_refills, prog.n_ops) == (jprog.n_refills, jprog.n_ops)
        assert spill_auto_ok(prog) == jax_spill_auto_ok(jprog) == verdict


def test_block_engine_still_raises():
    """The block engine is ported (tests/test_torch_block_gather.py); its
    program refuses this tree's pair and count gates."""
    tree = mixed_tree()
    with pytest.raises(LogicError, match="block-gather"):
        make_propagator(tree, "cpu", engine="block")


def test_building_for_cuda_touches_no_card():
    tree = jax_synthetic(n_basic=64, n_gates=256, fanin=4, n_levels=5,
                         seed=1)
    fn = make_propagator(tree, torch.device("cuda"), engine="spill")
    assert fn.engine == "spill"
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# The ring kernel's op stream of a spill program (csrc/spill.cu runs
# csrc/replay_ops.cuh's ring kernel).
# ---------------------------------------------------------------------------

#: ``chip_smoke.py``'s forced small schedule (``SPILL_SMALL``) on the 16k
#: tree: staging spills, evictions, refills from the staged input and
#: from scratch, five segments, and scratch rows read back within a few
#: ring entries of their EVICT.
SPILL_SMALL = dict(pool_slots=16, chunk_tiles=256, slab_tiles=8,
                   max_ops_per_segment=2048, hoist_events=16)
_RING_CASES: dict = {}


def ring_case(label: str):
    """(encoded spill program, staged input, house) of a ring case."""
    if label not in _RING_CASES:
        if label == "small-16k":
            tree = jax_synthetic(n_basic=8192, n_gates=16384, fanin=4,
                                 n_levels=14, seed=0)
            enc = tsk.encode_spill(tsk.compile_spill_stream(tree,
                                                            **SPILL_SMALL))
        elif label == "reused-rows":
            enc = reuse_scratch_rows(ring_case("small-16k")[0])
        else:
            tree = jax_synthetic(n_basic=256, n_gates=2048, fanin=4,
                                 n_levels=8, seed=3)
            enc = tsk.encode_spill(tsk.compile_spill_stream(tree))
        p = torch.from_numpy(uniform((8, len(enc.staged_cols)), 21,
                                     hi=0.05))
        _RING_CASES[label] = (enc, tsk.stage_basic(enc, p),
                              tsk.house_tensor(enc, [], "cpu"))
    return _RING_CASES[label]


def reuse_scratch_rows(enc):
    """``enc`` with its scratch rows reassigned as registers are: an
    EVICT takes a row whose last REFILL came before it, so rows are
    stored more than once (the Belady builder does not promise one store
    per row)."""
    ops = enc.ops.copy()
    last_read: dict[int, int] = {}
    for o, (kind, _s, _b, _e, row, _a, _r) in enumerate(ops.tolist()):
        if kind == tsk.REFILL:
            last_read[row] = o
    new_row: dict[int, int] = {}
    free_at: list = []          # (op after which the row is free, row)
    n_rows = 0
    for o, (kind, _s, _b, _e, row, _a, _r) in enumerate(ops.tolist()):
        if kind == tsk.EVICT:
            free = [r for end, r in free_at if end < o]
            if free:
                new_row[row] = free[0]
                free_at = [(end, r) for end, r in free_at if r != free[0]]
            else:
                new_row[row], n_rows = n_rows, n_rows + 1
            free_at.append((last_read.get(row, o), new_row[row]))
            ops[o, 4] = new_row[row]
        elif kind == tsk.REFILL:
            ops[o, 4] = new_row[row]
    return tsk.EncodedSpill(
        ops=ops, args=enc.args, fill=enc.fill, n_log=enc.n_log,
        n_basic=enc.n_basic, n_house=enc.n_house, pool_slots=enc.pool_slots,
        top_slot=enc.top_slot, max_count_states=enc.max_count_states,
        staged_cols=enc.staged_cols, out_slots=enc.out_slots,
        n_scratch=n_rows, counts=enc.counts)


def issue_order(enc, ring):
    """Walk the ring stream's words as the kernel does; returns the
    consumption index at which each EVICT stores (its pads follow it)
    and, for every eviction-log fetch, (its issue index, its entry index,
    its row)."""
    D = ring.depth
    assert all(c < tsk._RING_EVLOG for c in ring.head.tolist())
    stores, fetches = [], []
    k = 0
    words = ring.words.reshape(ring.n_chunks, ring.chunk_words).tolist()

    def consume(code):
        nonlocal k
        if code >= tsk._RING_EVLOG:
            fetches.append((k, k + D - 1, code - tsk._RING_EVLOG))
        k += 1
    for chunk in words:
        w = 0
        while chunk[w] >= 0:
            kind, b, e, aux0, extra = chunk[w], chunk[w + 2], chunk[w + 3], \
                chunk[w + 4], chunk[w + 7]
            if kind == tsk.EVICT:
                stores.append((k, aux0))
                for j in range(b, e):
                    consume(chunk[j] & tsk._PAYLOAD)
            elif kind == tsk.REFILL:
                consume(extra)
            else:
                for x in chunk[b:e]:
                    if (x & 0xFFFFFFFF) >> 30 == tsk._W_RING:
                        consume(x & tsk._PAYLOAD)
            w = e
    return stores, fetches


@pytest.mark.parametrize("depth", tsk.REPLAY_RING_DEPTHS)
@pytest.mark.parametrize("label", ["small-16k", "default-2k",
                                   "reused-rows"])
def test_ring_walk_equals_plain(label, depth):
    """The kernel's walk of the spill program's ring stream, at every
    ring depth the kernel is built for, bit-equal to
    ``spill_forward_plain``: the forced small schedule (every op kind
    through the ring, pads at every depth), a 2,048-gate tree at the
    default sizing, and the small schedule with its scratch rows reused."""
    enc, staged, house = ring_case(label)
    if label == "small-16k":
        assert all(enc.counts.values()), enc.counts
        kinds = set(enc.ops[:, 0].tolist())
        assert {tsk.SPILL, tsk.EVICT, tsk.REFILL, tsk.PROD} <= kinds
    ring = tsk.replay_ring_stream(enc, depth)
    if label != "default-2k":
        assert ring.n_pads > 0
    top, _ = walk_ring(enc, ring, staged, house)
    assert torch.equal(top, tsk.spill_forward_plain(enc, staged, house))


@pytest.mark.parametrize("label", ["small-16k", "reused-rows"])
def test_scratch_fetches_follow_their_evict(label):
    """Every scratch fetch is issued at or after the EVICT that stores the
    value its read takes (the latest store of its row before the read),
    and no other store to that row falls between the issue and the
    read; the ring's reads are the program's SPILL, staged-argument and
    REFILL reads in order."""
    enc, _staged, _house = ring_case(label)
    rows = enc.ops[enc.ops[:, 0] == tsk.EVICT, 4]
    if label == "reused-rows":
        assert len(np.unique(rows)) < len(rows)   # rows stored twice
    else:
        assert len(np.unique(rows)) == len(rows)
    want = []
    for kind, _slot, b, e, aux0, _a1, _row in enc.ops.tolist():
        if kind == tsk.REFILL:
            want.append(tsk._RING_EVLOG + aux0)
        elif kind != tsk.EVICT:
            want += [idx + 1 for src, idx, *_r in enc.args[b:e].tolist()
                     if src == tsk.STAGED]
    for depth in tsk.REPLAY_RING_DEPTHS:
        ring = tsk.replay_ring_stream(enc, depth)
        assert [f for f in ring.fetches.tolist() if f] == want
        stores, fetches = issue_order(enc, ring)
        for issue, entry, row in fetches:
            before = [at for at, r in stores if r == row and at <= entry]
            assert before and before[-1] <= issue, (depth, row)


def test_a_read_before_any_store_is_refused():
    enc, _staged, _house = ring_case("small-16k")
    ops = enc.ops.copy()
    first = int(np.flatnonzero(ops[:, 0] == tsk.REFILL)[0])
    ops[first, 4] = enc.n_scratch - 1     # the last row, stored later
    bad = tsk.EncodedSpill(
        ops=ops, args=enc.args, fill=enc.fill, n_log=enc.n_log,
        n_basic=enc.n_basic, n_house=enc.n_house, pool_slots=enc.pool_slots,
        top_slot=enc.top_slot, max_count_states=enc.max_count_states,
        staged_cols=enc.staged_cols, out_slots=enc.out_slots,
        n_scratch=enc.n_scratch, counts=enc.counts)
    with pytest.raises(LogicError, match="before any EVICT"):
        tsk.replay_ring_stream(bad, 8)
