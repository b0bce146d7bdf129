"""Torch port: every event-tree sequence root as one multi-root stream
program (``ops/stream_kernel.compile_tree_stream`` with ``roots``), as
``engine/sequences.root_groups`` builds it (``compile_event_tree`` does on
CUDA, where the BDD forest gives up), on the CPU through the kernel's
plain version.

Trees: the plant-width event tree (64 sequences; count gates), the small
lognormal tree of ``test_torch_event_tree_serve.py`` (a 2-of-3 vote),
``demo_plant`` (products, a house event, a CCF group) and the scale model
with a path-local house flip (two house rows, so two programs); each
compiled with its forest forced to give up at its first node.

* The program runs each gate of the roots' cones once (777 on the plant
  tree), in the order of one depth-first walk over the roots in turn
  with one visited set.
* Its pool is the live set of that order, each root held to the end (76
  slots on the plant tree).
* Its plain version equals the gather engine's roots at 2^10 trials: to
  the bit on product-only programs (the same arguments in the same
  order); within 1e-12 absolute where count gates occur, since the
  stream's count DP may count over the complemented arguments
  (``count_window``) and rounds its absorbing state in another order.
* Roots group by house row, one program per row; the single-top
  program is the one-root program, its output table its top slot.
"""

import os

import numpy as np
import pytest
import torch

import canopy_tpu_torch.compiler.bdd as port_bdd
from canopy_tpu_torch.compiler.graph import compile_fault_tree
from canopy_tpu_torch.compiler.schedule import _emit_gate_ops
from canopy_tpu_torch.engine.propagate import propagate_probability
from canopy_tpu_torch.engine.sequences import (compile_event_tree,
                                               root_groups)
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.ops import stream_kernel as tsk
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils.profiling import counters
from canopy_tpu_torch.utils.scale_models import event_tree_scale_xml

from test_torch_event_tree_serve import small_xml
from torch_parity import fixture_inputs, fixture_path, launches_since

TREES = ["plant", "small", "demo", "house-flip"]
N_TRIALS = 1 << 10
#: Count-gate programs against the gather engine (module docstring).
COUNT_ATOL = 1e-12


def _paths(name: str, tmp) -> list[str]:
    if name == "plant":
        return fixture_inputs("torch_event_tree_plant")
    if name == "demo":
        return [fixture_path("demo_plant")]
    path = os.path.join(tmp, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write(small_xml() if name == "small" else
                 event_tree_scale_xml(n_fe=3, deviates=True,
                                      house_flip=True))
    return [path]


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Each tree compiled on the CPU with its forest forced to give up,
    and its root programs built as a CUDA compile builds them."""
    original = port_bdd.build_bdd_multi

    def give_up(tree, root_slots, max_nodes=None, *args, **kwargs):
        return original(tree, root_slots, 2, *args, **kwargs)
    tmp = str(tmp_path_factory.mktemp("trees"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_bdd, "build_bdd_multi", give_up)
        for name in TREES:
            settings = Settings()
            model = Initializer(_paths(name, tmp), settings).model
            (initiating,) = model.initiating_events
            c = compile_event_tree(model, initiating, settings, "cpu")
            assert c.root_groups == []    # the CPU runs the gather engine
            c.root_groups = root_groups(c)
            out[name] = c
    return out


def one_walk(tree, roots: list[int]) -> list:
    """The gate rows of ``roots``' cones in one depth-first post-order
    over the roots in turn, one visited set for all of them."""
    rows = {row[1]: row for row in _emit_gate_ops(tree)}
    base = tree.n_basic + tree.n_house
    order, seen = [], set()
    for root in roots:
        stack = [(root, False)]
        while stack:
            slot, expanded = stack.pop()
            if expanded:
                order.append(rows[slot])
                continue
            if slot in seen:
                continue
            seen.add(slot)
            stack.append((slot, True))
            for arg, _flag in reversed(rows[slot][2]):
                if arg >= base and arg not in seen:
                    stack.append((arg, False))
    return order


def peak_live(order: list, roots: list[int], base: int) -> int:
    """The most gate values alive at once when ``order`` runs: each from
    its op to its last reader, a root to the end."""
    last = {}
    for g, (_kind, _out, args, _aux) in enumerate(order):
        for arg, _flag in args:
            if arg >= base:
                last[arg] = g
    end = len(order)
    alive = [0] * (end + 2)
    for g, (_kind, out, _args, _aux) in enumerate(order):
        stop = end if out in roots else last.get(out, g)
        alive[g] += 1
        alive[stop + 1] -= 1
    return max(np.cumsum(alive[:end]))


def group_roots(c, group) -> list[int]:
    return [c.root_slots[k] for k in group.roots]


@pytest.mark.parametrize("name", TREES)
def test_each_gate_runs_once_in_one_walk(compiled, name):
    c = compiled[name]
    assert c.root_bdds is None and c.root_groups
    n_ops = 0
    for group in c.root_groups:
        roots = group_roots(c, group)
        program = tsk.compile_tree_stream(c.tree, roots)
        gates = [op for op in program.ops if op[0] == "gate"]
        order = one_walk(c.tree, roots)
        assert len({row[1] for row in order}) == len(order) == len(gates)
        assert [(op[1], len(op[3]), op[4]) for op in gates] == \
            [(kind, len(args), aux) for kind, _o, args, aux in order]
        assert group.program.n_ops == len(gates)
        n_ops += len(gates)
    if name == "plant":
        assert (n_ops, len(c.root_slots)) == (777, 64)


@pytest.mark.parametrize("name", TREES)
def test_pool_is_the_live_set(compiled, name):
    c = compiled[name]
    base = c.tree.n_basic + c.tree.n_house
    for group in c.root_groups:
        roots = group_roots(c, group)
        enc = group.program
        assert enc.pool_slots == peak_live(one_walk(c.tree, roots), roots,
                                           base)
        assert len(enc.out_slots) == len(roots)
        assert enc.out_slots[0] == enc.top_slot
        if name == "plant":
            assert enc.pool_slots == 76


@pytest.mark.parametrize("name", TREES)
def test_plain_roots_equal_the_gather_engine(compiled, name):
    c = compiled[name]
    rng = np.random.default_rng(41)
    basic = torch.from_numpy(np.exp(rng.uniform(
        np.log(1e-4), np.log(0.3), (N_TRIALS, c.tree.n_basic))))
    has_count = False
    start = counters()
    for group in c.root_groups:
        enc = group.program
        staged = basic[:, group.cols].T.contiguous()
        got = tsk.stream_roots_forward(enc, staged, group.house)
        assert got.dtype == torch.float64
        assert got.shape == (len(group.roots), N_TRIALS)
        house = torch.as_tensor(c.house_rows[group.roots[0]])
        want = propagate_probability(c.tree, basic, house)[
            :, group_roots(c, group)].T
        if (enc.ops[:, 0] == tsk.COUNT).any():
            has_count = True
            assert float((got - want).abs().max()) <= COUNT_ATOL
        else:
            assert torch.equal(got, want)
    assert has_count == (name in ("plant", "small"))
    assert launches_since(start) == {}


@pytest.mark.parametrize("name", TREES)
def test_roots_group_by_house_row(compiled, name):
    c = compiled[name]
    rows = {h.tobytes() for h in c.house_rows}
    assert len(c.root_groups) == len(rows) == (2 if name == "house-flip"
                                              else 1)
    assert sorted(k for g in c.root_groups for k in g.roots) == \
        list(range(len(c.root_slots)))
    for group in c.root_groups:
        for k in group.roots:
            np.testing.assert_array_equal(c.house_rows[k],
                                          group.house[:-1].numpy())
        assert group.house.dtype == torch.float64
        assert torch.equal(group.cols,
                           torch.from_numpy(group.program.staged_cols))


@pytest.mark.parametrize("name", ["demo_plant", "aralia_like_ccf",
                                  "aralia_like_nested_count",
                                  "torch_slice_plant"])
def test_single_top_program_is_the_one_root_program(name):
    model = Initializer(fixture_inputs(name),
                        Settings().ccf_analysis(True)).model
    fault_tree = model.fault_trees.get(
        {"demo_plant": "Cooling", "torch_slice_plant": "slice"}.get(
            name, name))
    tree = compile_fault_tree(fault_tree)
    single = tsk.encode_stream(tsk.compile_tree_stream(tree))
    rooted = tsk.encode_stream(tsk.compile_tree_stream(tree,
                                                       [tree.top_index]))
    for field in ("ops", "args", "fill", "staged_cols", "out_slots"):
        np.testing.assert_array_equal(getattr(single, field),
                                      getattr(rooted, field))
    assert (single.pool_slots, single.top_slot, single.n_basic) == \
        (rooted.pool_slots, rooted.top_slot, rooted.n_basic)
    assert single.out_slots.tolist() == [single.top_slot]


def test_roots_wrapper_checks_its_inputs(compiled):
    c = compiled["demo"]
    (group,) = c.root_groups
    staged = torch.zeros((group.program.n_basic, 8), dtype=torch.float64)
    with pytest.raises(LogicError):
        tsk.stream_roots_forward(group.program, staged,
                                 group.house.to(torch.float32))
    with pytest.raises(LogicError):
        tsk.stream_roots_forward(group.program, staged[1:], group.house)
    with pytest.raises(LogicError):
        tsk.compile_tree_stream(c.tree, [0])   # a basic event's slot
