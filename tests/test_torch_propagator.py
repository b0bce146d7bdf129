"""Torch port, ``make_propagator`` and the uncapped tree stream on the CPU.

* Every CPU engine of ``make_propagator`` against the JAX package's f64
  ``top_event_probability`` on the same numpy inputs: the f64 gather
  engine (``auto`` and ``gather``) within 1e-12 relative, the float32
  engines (``fused``, ``stream``: the kernels' plain versions) within
  1e-6 relative plus 2^-24 absolute (an OR of small probabilities is
  ``1 - prod(1 - p)``, and float32 rounds each ``1 - p`` to an absolute
  half ulp of 1.0, which is more than 1e-6 of a top near 1e-4).
* Auto dispatch on CUDA (decided without a card: building a kernel
  engine touches no device) picks the stream on every tree with an
  anchored top; ``engine="fused"`` still picks the tiled kernel, then
  the lane-row one; gather only for ``output="all"``.
* ``compile_tree_stream`` gives the shared scheduler's tables wherever
  that scheduler spills nothing, and schedules a tree it rejects (a gate
  reading 800 staged basics, beyond 3 x 256), matching gather there.
* The top cone is a fixed point of ``prune_to_top_cone``; a per-call
  house override raises on the kernel engines; staged results equal
  unstaged ones; the replay and spill engines build, and the block
  engine refuses a tree with non-product gates.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from canopy_tpu.compiler.graph import compile_gates as jax_compile_gates
from canopy_tpu.engine.propagate import \
    top_event_probability as jax_top_probability
from canopy_tpu.ops.stream_kernel import compile_stream as jax_compile_stream
from canopy_tpu_torch.compiler.graph import compile_gates, prune_to_top_cone
from canopy_tpu_torch.engine.propagate import (make_propagator,
                                               make_staged_propagator,
                                               top_event_probability)
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                        Formula, Gate)
from canopy_tpu_torch.mef.expr.constant import ConstantExpression
from canopy_tpu_torch.ops import fused_kernel as tfk
from canopy_tpu_torch.ops import stream_kernel as tsk
from canopy_tpu_torch.utils.synthetic import (synthetic_hierarchical_tree,
                                              synthetic_mef_tree)

from torch_parity import ALL_FIXTURES, load_tree

CASES = [("aralia_like_ccf", None), ("aralia_like_noncoherent", None),
         ("aralia_like_medium", None), ("demo_plant", "Cooling"),
         ("torch_slice_plant", "slice")]


def inputs(n_basic: int, n_trials: int, seed: int) -> np.ndarray:
    """PRA-scale f64 probabilities, log-uniform over 1e-3..0.2."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-3), np.log(0.2),
                              (n_trials, n_basic)))


def rel_err(got: torch.Tensor, want: np.ndarray, atol: float = 0.0
            ) -> float:
    """Largest error beyond ``atol``, relative to the reference."""
    want = np.asarray(want, dtype=np.float64)
    err = np.maximum(np.abs(got.double().numpy() - want) - atol, 0.0)
    return float(np.max(err / np.abs(want)))


#: Absolute slack of the float32 engines against f64 (see above).
F32_ATOL = 2.0 ** -24


def jax_top(tree, p: np.ndarray) -> np.ndarray:
    """The JAX package's f64 gather engine, jitted (eager dispatch of its
    level ops takes seconds)."""
    import jax
    return np.asarray(jax.jit(lambda q: jax_top_probability(tree, q))(
        jnp.asarray(p)))


@pytest.mark.parametrize("name,tree_name", CASES)
def test_cpu_engines_match_jax_gather(name, tree_name):
    _jm, jt = load_tree("canopy_tpu", name, tree_name=tree_name)
    _tm, tt = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    p = inputs(tt.n_basic, 300, 21)
    want = jax_top(jt, p)
    t = torch.from_numpy(p)
    for engine, tol, atol in [("auto", 1e-12, 0.0), ("gather", 1e-12, 0.0),
                              ("fused", 1e-6, F32_ATOL),
                              ("stream", 1e-6, F32_ATOL)]:
        fn = make_propagator(tt, "cpu", engine=engine)
        got = fn(t)
        assert got.shape == (300,)
        assert rel_err(got, want, atol) <= tol, (engine, rel_err(got, want))
        assert fn.engine == {"auto": "gather", "fused": "fused_tiled"}.get(
            engine, engine)


def test_auto_dispatch_on_cuda():
    cuda = torch.device("cuda")
    _m, slice_tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                               tree_name="slice")
    _m, large = load_tree("canopy_tpu_torch", "aralia_like_large")
    big = synthetic_hierarchical_tree(n_basic=16384, branching=8,
                                      share_fraction=0.1, n_shared=32,
                                      seed=0)
    assert big.n_gates > 1816
    assert make_propagator(slice_tree, cuda).engine == "stream"
    assert make_propagator(large, cuda).engine == "stream"
    assert make_propagator(big, cuda).engine == "stream"
    assert make_propagator(slice_tree, cuda,
                           engine="fused").engine == "fused_tiled"
    assert make_propagator(large, cuda, engine="fused").engine == "fused"
    assert make_propagator(slice_tree, "cpu").engine == "gather"
    with pytest.raises(ValueError):
        make_propagator(big, cuda, engine="fused")
    with pytest.raises(ValueError):
        make_propagator(slice_tree, cuda, output="all", engine="fused")


def test_all_output_stays_on_gather():
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    fn = make_propagator(tree, "cpu", output="all")
    p = torch.from_numpy(inputs(tree.n_basic, 4, 22))
    assert fn.engine == "gather" and fn(p).shape == (4, tree.n_nodes)


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_tree_stream_equals_shared_schedule_without_spills(name):
    """Every fault tree of every fixture whose shared schedule spills
    nothing: identical op, argument and fill tables, pool and top."""
    import canopy_tpu.mef as jmef
    import canopy_tpu.settings as jset
    from canopy_tpu.compiler.graph import compile_fault_tree as jcompile
    from canopy_tpu_torch.compiler.graph import compile_fault_tree
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    from torch_parity import fixture_inputs
    path = fixture_inputs(name)
    jmodel = jmef.Initializer(path, jset.Settings().ccf_analysis(True)).model
    tmodel = Initializer(path, Settings().ccf_analysis(True)).model
    checked = 0
    for jft in jmodel.fault_trees:
        jt = jcompile(jft)
        tt = compile_fault_tree(tmodel.fault_trees.get(jft.name))
        try:
            shared = jax_compile_stream(jt)
        except Exception:   # Beyond the TPU caps: nothing to compare.
            continue
        if any(op[0] == "spill" for op in shared.ops):
            continue
        want = tsk.encode_stream(shared)
        got = tsk.encode_stream(tsk.compile_tree_stream(tt))
        for field in ("ops", "args", "fill"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert (got.pool_slots, got.top_slot, got.n_house) == \
            (want.pool_slots, want.top_slot, want.n_house)
        np.testing.assert_array_equal(got.staged_cols,
                                      want.staged_cols[:got.n_basic])
        checked += 1
    assert checked or not list(jmodel.fault_trees)


def wide_tree(pkg_compile, event_cls, gate_cls, arg_cls, formula_cls,
              connective, constant):
    """An AND of an 800-way OR and a 3-way OR: the first gate reads 800
    staged basics, more than a 3-deep ring of 256-tile chunks holds."""
    events = []
    for i in range(803):
        e = event_cls(f"w{i:03d}")
        e.expression = constant(1e-4 * (1 + i % 7))
        events.append(e)
    wide = gate_cls("wide")
    wide.formula = formula_cls(connective.OR,
                               [arg_cls(e) for e in events[:800]])
    small = gate_cls("small")
    small.formula = formula_cls(connective.OR,
                                [arg_cls(e) for e in events[800:]])
    top = gate_cls("top")
    top.formula = formula_cls(connective.AND, [arg_cls(wide),
                                               arg_cls(small)])
    tree = pkg_compile([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def test_tree_stream_schedules_what_the_shared_scheduler_rejects():
    from canopy_tpu.mef.event import Arg as JArg
    from canopy_tpu.mef.event import BasicEvent as JBasic
    from canopy_tpu.mef.event import Connective as JConn
    from canopy_tpu.mef.event import Formula as JFormula
    from canopy_tpu.mef.event import Gate as JGate
    from canopy_tpu.mef.expr.constant import ConstantExpression as JConst
    from canopy_tpu.errors import LogicError as JaxLogicError
    jt = wide_tree(jax_compile_gates, JBasic, JGate, JArg, JFormula, JConn,
                   JConst)
    tt = wide_tree(compile_gates, BasicEvent, Gate, Arg, Formula,
                   Connective, ConstantExpression)
    with pytest.raises(JaxLogicError):
        jax_compile_stream(jt)
    with pytest.raises(LogicError):
        tsk.compile_stream(tt)
    program = tsk.compile_tree_stream(tt)
    assert program.n_basic == 803 and program.n_chunks == 1
    # The reference is the port's f64 gather engine (held to the JAX one
    # above; JAX's jit of an 800-column gather takes many seconds).
    p = torch.from_numpy(inputs(tt.n_basic, 64, 23) * 0.01)
    want = make_propagator(tt, "cpu", engine="gather")(p).numpy()
    got = make_propagator(tt, "cpu", engine="stream")(p)
    assert rel_err(got, want, F32_ATOL) <= 1e-6


def test_tree_stream_refuses_only_without_top_or_basics():
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    assert tsk.tree_stream_encoding(tree) is tsk.tree_stream_encoding(tree)
    tree.top_index = None
    with pytest.raises(LogicError):
        tsk.compile_tree_stream(tree)
    house = Gate("only-house")
    from canopy_tpu_torch.mef.event import HouseEvent
    h = HouseEvent("h")
    house.formula = Formula(Connective.OR, [Arg(h), Arg(HouseEvent("g"))])
    ht = compile_gates([house])
    ht.top_index = ht.gate_index["only-house"]
    with pytest.raises(LogicError):
        tsk.compile_tree_stream(ht)


def multi_root_tree():
    """A synthetic tree compiled together with a gate outside its cone."""
    top, events = synthetic_mef_tree(n_basic=30, n_gates=25, seed=3,
                                     atleast_fraction=0.2)
    extra = Gate("outside")
    extra.formula = Formula(Connective.AND, [Arg(events[0]),
                                             Arg(events[1])])
    tree = compile_gates([extra, top])
    tree.top_index = tree.gate_index[top.id]
    return tree


@pytest.mark.parametrize("name", ["multi-root"] + ALL_FIXTURES)
def test_top_cone_is_a_fixed_point(name):
    if name == "multi-root":
        trees = [multi_root_tree()]
    else:
        import canopy_tpu_torch.mef as tmef
        from canopy_tpu_torch.compiler.graph import compile_fault_tree
        from canopy_tpu_torch.settings import Settings
        from torch_parity import fixture_inputs
        model = tmef.Initializer(fixture_inputs(name),
                                 Settings().ccf_analysis(True)).model
        trees = [compile_fault_tree(ft) for ft in model.fault_trees]
    for tree in trees:
        cone = prune_to_top_cone(tree)
        again = prune_to_top_cone(cone)
        assert again is cone
        if name == "multi-root":
            assert cone.n_gates == tree.n_gates - 1
        # Strict leveling: every argument of a gate lies in an earlier
        # level (or is a basic/house slot), so one reverse sweep reaches
        # the whole cone.
        base = cone.n_basic + cone.n_house
        done = set(range(base))
        for level in cone.levels:
            outs = []
            for _kind, b in level.iter_blocks():
                args = np.asarray(b.arg_idx)
                mask = getattr(b, "arg_mask", None)
                used = args[np.asarray(mask)] if mask is not None else args
                assert set(used.reshape(-1).tolist()) <= done
                outs += np.asarray(b.out_idx).tolist()
            done |= set(outs)
        p = torch.from_numpy(inputs(tree.n_basic, 8, 24))
        h = torch.as_tensor(tree.house_state_vector())
        assert torch.equal(top_event_probability(cone, p, h),
                           top_event_probability(tree, p, h))


def test_house_override_raises_on_kernel_engines():
    _m, tree = load_tree("canopy_tpu_torch", "demo_plant",
                         tree_name="Cooling")
    p = torch.from_numpy(inputs(tree.n_basic, 16, 25))
    on = np.ones(tree.n_house)
    for engine in ("fused", "stream"):
        fn = make_propagator(tree, "cpu", engine=engine)
        with pytest.raises(ValueError):
            fn(p, torch.as_tensor(on))
        baked = make_propagator(tree, "cpu", engine=engine,
                                house_states=on)(p)
        assert not torch.equal(baked, fn(p))
    gather = make_propagator(tree, "cpu")
    np.testing.assert_allclose(
        gather(p, torch.as_tensor(on)).numpy(),
        make_propagator(tree, "cpu", house_states=on)(p).numpy(),
        rtol=0, atol=0)


def test_staged_equals_unstaged():
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_noncoherent")
    p = torch.from_numpy(inputs(tree.n_basic, 100, 26))
    stage, run = make_staged_propagator(tree, "cpu", engine="stream")
    assert run.engine == "stream"
    assert torch.equal(run(stage(p)),
                       make_propagator(tree, "cpu", engine="stream")(p))
    stage, run = make_staged_propagator(tree, "cpu")
    assert run.engine == "gather" and stage(p) is p
    assert torch.equal(run(p), make_propagator(tree, "cpu")(p))
    assert torch.equal(
        tfk.fused_propagate_tiled_staged(tree, tfk.tile_trials(p), []),
        tfk.fused_propagate_tiled(tree, p, []))


@pytest.mark.parametrize("engine", ["replay", "spill", "block"])
def test_unported_engines_raise(engine):
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    if engine in ("replay", "spill"):
        # Ported (tests/test_torch_replay.py, tests/test_torch_spill.py):
        # it builds, and like every kernel engine refuses a per-call house
        # override.
        fn = make_propagator(tree, "cpu", engine=engine)
        assert fn.engine == engine
        p = torch.from_numpy(inputs(tree.n_basic, 4, 27))
        with pytest.raises(ValueError):
            fn(p, torch.ones(max(tree.n_house, 1)))
        return
    # Ported (tests/test_torch_block_gather.py): its program, built here,
    # refuses this tree's non-product gates, as the JAX package's does.
    with pytest.raises(LogicError, match="block-gather"):
        make_propagator(tree, "cpu", engine=engine)
