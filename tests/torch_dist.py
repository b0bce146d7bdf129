"""Spawned gloo ranks for the torch port's parallel tests.

Port-only on purpose: ``torch.multiprocessing.spawn`` pickles the worker
by reference, so every rank imports this module (never a test module,
which imports JAX).  Ranks meet through a ``file://`` rendezvous in the
test's temporary directory (no fixed port, so concurrent test processes
cannot clash) with a timeout on every collective, take numpy inputs and
write numpy results back as one pickle per rank.

:func:`run_ranks` spawns ``world`` CPU ranks once and runs every case of
:func:`parallel_suite` in them; the test module reads rank 0's results
(and checks that the ranks agree).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

#: Seconds any collective may wait before the rank fails (instead of
#: hanging the test).
TIMEOUT_S = 60


def run_ranks(world: int, workdir: str, payload: dict) -> list[dict]:
    """Spawn ``world`` gloo ranks on the CPU; each runs
    :func:`parallel_suite` on ``payload``.  Returns each rank's results."""
    import torch.multiprocessing as mp
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "payload.pkl"), "wb") as fh:
        pickle.dump(payload, fh)
    mp.spawn(_worker, args=(world, workdir), nprocs=world, join=True)
    results = []
    for rank in range(world):
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _worker(rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    from canopy_tpu_torch.parallel.distributed import initialize
    torch.set_num_threads(1)
    initialize(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
               device="cpu", timeout=TIMEOUT_S)
    with open(os.path.join(workdir, "payload.pkl"), "rb") as fh:
        payload = pickle.load(fh)
    try:
        out = parallel_suite(payload)
    finally:
        dist.destroy_process_group()
    out["imports_jax"] = sorted(m for m in sys.modules if m == "jax" or
                                m.startswith(("jax.", "canopy_tpu.")))
    with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def group_tree(n_groups: int = 8):
    """``tests/test_parallel.py``'s tree (an OR of ``n_groups`` ANDs of
    three basic events), built with the port's MEF classes."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    from canopy_tpu_torch.mef.expr import ConstantExpression
    gates = []
    for g in range(n_groups):
        group = []
        for i in range(3):
            e = BasicEvent(f"e{g}_{i}")
            e.expression = ConstantExpression(0.01 * (g + 1) + 0.001 * i)
            group.append(e)
        gate = Gate(f"g{g}")
        gate.formula = Formula(Connective.AND, [Arg(e) for e in group])
        gates.append(gate)
    top = Gate("top")
    top.formula = Formula(Connective.OR, [Arg(g) for g in gates])
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree, top


def mef_tree(seed: int, **kw):
    """``tests/test_partition.py``'s synthetic MEF tree, in the port."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.utils.synthetic import synthetic_mef_tree
    top, _events = synthetic_mef_tree(seed=seed, **kw)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    return tree


#: The replay schedule of ``tests/test_parallel.py::TestShardedReplay``.
REPLAY_TREE = dict(n_basic=96, n_gates=900, fanin=4, n_levels=10, seed=7)
REPLAY_SCHEDULE = dict(pool_slots=12, slab_bufs=3, slab_tiles=8,
                       brs_chunk=16, brs_bufs=3, grs_chunk=8, grs_bufs=2,
                       max_ops_per_segment=150)


def replay_encoding():
    from canopy_tpu_torch.ops.stream_kernel import (compile_replay_stream,
                                                    encode_replay)
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(**REPLAY_TREE)
    return tree, encode_replay(compile_replay_stream(tree, **REPLAY_SCHEDULE))


def stream_encoding(tree):
    from canopy_tpu_torch.ops.stream_kernel import (compile_stream,
                                                    encode_stream)
    return encode_stream(compile_stream(tree, chunk_tiles=4))


def parallel_suite(payload: dict) -> dict:
    """Every case of ``tests/test_torch_parallel.py`` on this world: the
    port's steps on each rank's shard, gathered back to the global view.
    ``payload`` maps a case to its numpy inputs."""
    import torch.distributed as dist
    from canopy_tpu_torch.compiler.cutsets import CutSetGenerator
    from canopy_tpu_torch.engine.cutset_quantify import build_cutset_matrix
    from canopy_tpu_torch.errors import LogicError
    from canopy_tpu_torch.parallel.dryrun import dryrun_multichip
    from canopy_tpu_torch.parallel.mesh import make_mesh
    from canopy_tpu_torch.parallel.partition import \
        make_partitioned_propagator
    from canopy_tpu_torch.parallel.pipeline import (make_pipe_mesh,
                                                    make_pipeline_propagator)
    from canopy_tpu_torch.parallel.quantify import (
        gather_trials, shard_trials, sharded_cutset_quantifier,
        sharded_replay_step, sharded_stream_grad_step, sharded_stream_step,
        sharded_uncertainty_step)
    from canopy_tpu_torch.utils.synthetic import (synthetic_compiled_tree,
                                                  synthetic_hierarchical_tree)

    world = dist.get_world_size()
    out: dict = {}
    mesh = make_mesh("cpu")
    out["mesh"] = (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))

    def np_(t: torch.Tensor) -> np.ndarray:
        return t.detach().numpy()

    def dp(step, x, axes=None, *args):
        return np_(gather_trials(mesh, step(shard_trials(mesh, x, axes),
                                            *args), axes))

    tree8, _top = group_tree()
    house8 = tree8.house_state_vector()
    out["uncertainty"] = dp(sharded_uncertainty_step(tree8, mesh),
                            torch.from_numpy(payload["uncertainty"]), None,
                            house8)

    for case, groups in (("cutset", 8), ("cutset_ragged", 5)):
        tree, top = group_tree(groups)
        matrix = build_cutset_matrix(CutSetGenerator(tree).generate(top),
                                     tree.n_basic)
        for label, m in (("", mesh), ("_tp", make_mesh(
                "cpu", model_parallelism=world))):
            quantify = sharded_cutset_quantifier(matrix, m)
            re_l, mcub_l = quantify(shard_trials(
                m, torch.from_numpy(payload[case]), ("data",)))
            out[case + label] = (
                matrix.n_products,
                np_(gather_trials(m, re_l, ("data",))),
                np_(gather_trials(m, mcub_l, ("data",))))

    tree12, _top = group_tree(12)
    house12 = tree12.house_state_vector()
    enc = stream_encoding(tree12)
    basic = torch.from_numpy(payload["stream"])
    out["stream"] = dp(sharded_stream_step(enc, mesh, house12), basic)
    grad_step = sharded_stream_grad_step(enc, mesh, house12)
    tops_g, grad_g = grad_step(shard_trials(mesh, basic))
    out["grad"] = (np_(gather_trials(mesh, tops_g)),
                   np_(gather_trials(mesh, grad_g)))
    try:
        shard_trials(mesh, basic[:world * 3 + 1])
        out["uneven"] = None
    except LogicError as exc:
        out["uneven"] = str(exc)

    rp_tree, rp_enc = replay_encoding()
    out["replay_evicted"] = rp_enc.n_evicted
    out["replay"] = dp(sharded_replay_step(rp_enc, mesh,
                                           rp_tree.house_state_vector()),
                       torch.from_numpy(payload["replay"]))

    for seed in (5, 6, 7):
        tree = mef_tree(seed, n_basic=40, n_gates=35, fanin=3)
        out[f"partition_{seed}"] = dp(
            make_partitioned_propagator(tree, mesh),
            torch.from_numpy(payload[f"partition_{seed}"]), ("data",),
            tree.house_state_vector())
    tree = mef_tree(11, n_basic=30, n_gates=25, fanin=3)
    tp_mesh = make_mesh("cpu", model_parallelism=world)
    out["partition_tp"] = np_(gather_trials(tp_mesh, make_partitioned_propagator(
        tree, tp_mesh)(shard_trials(tp_mesh, torch.from_numpy(
            payload["partition_tp"]), ("data",)), tree.house_state_vector()),
        ("data",)))

    pp_tree = synthetic_compiled_tree(n_basic=128, n_gates=512, fanin=3,
                                      n_levels=9, seed=0)
    layouts = [(world, 1)] + ([(world // 2, 2)] if world % 2 == 0 else [])
    for pipe, data in layouts:
        pp_mesh = make_pipe_mesh("cpu", pipe=pipe, data=data)
        fn = make_pipeline_propagator(pp_tree, pp_mesh, n_micro=2 * pipe)
        x = torch.from_numpy(payload[f"pipeline_{pipe}x{data}"])
        out[f"pipeline_{pipe}x{data}"] = np_(gather_trials(
            pp_mesh, fn(shard_trials(pp_mesh, x, ("data",)), np.zeros(0)),
            ("data",)))
    deep = synthetic_hierarchical_tree(n_basic=256, branching=2, seed=1)
    pp_mesh = make_pipe_mesh("cpu", pipe=world)
    fn = make_pipeline_propagator(deep, pp_mesh, n_micro=8)
    out["pipeline_deep"] = np_(fn(torch.from_numpy(payload["pipeline_deep"]),
                                  np.zeros(0)))
    try:
        fn(torch.zeros((12, deep.n_basic), dtype=torch.float32), np.zeros(0))
        out["pipeline_bad"] = None
    except LogicError as exc:
        out["pipeline_bad"] = str(exc)

    out["dryrun"] = dryrun_multichip(mesh, "cpu")
    return out
