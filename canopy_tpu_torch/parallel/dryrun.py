"""The multi-rank dry run: every parallel path on small trees, each held
to the unsharded single-device result on the same trials.

The nine checks of the JAX package's ``__graft_entry__.dryrun_multichip``,
in its order.  Every rank calls :func:`dryrun_multichip` with the same
mesh; each draws the same global inputs from one seed, computes the
unsharded reference itself, runs its shard and gathers the result.  The
three kernel checks (5, 7, 8) run the port's real local — on CUDA the
stream, adjoint and replay kernels, on the CPU their plain versions —
where the JAX dry run substitutes a jnp local (its interpret-mode Pallas
deadlocks under a multi-device ``shard_map``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..errors import LogicError
from .distributed import all_reduce
from .quantify import gather_trials, shard_trials

__all__ = ["dryrun_multichip"]

#: Tolerances: f64 paths within ``F64_RTOL`` relative of one device; f32
#: kernel tops within ``TOP_RTOL``/``TOP_ATOL`` of the f64 gather engine,
#: gradients within ``GRAD_RTOL``/``GRAD_ATOL`` of torch autograd through
#: the f32 gather engine (``tests/test_parallel.py``'s).
F64_RTOL = 1e-12
TOP_RTOL, TOP_ATOL = 2e-6, 1e-7
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-8


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise LogicError(f"dryrun_multichip: {what}")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> float:
    """Largest ``|got - want| / (atol + rtol * |want|)`` (<= 1 passes)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _t(array: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(array, dtype=dtype).to(device)


def dryrun_multichip(mesh, device) -> dict:
    """Run the nine checks on ``mesh`` (a ("data", "model") mesh over the
    world, every rank calling); raise ``LogicError`` on the first that
    fails.  Returns what each check measured."""
    from ..compiler.cutsets import CutSetGenerator
    from ..compiler.graph import compile_gates
    from ..engine.cutset_quantify import (build_cutset_matrix, mcub,
                                          product_probabilities, rare_event)
    from ..engine.propagate import (propagate_probability,
                                    top_event_probability)
    from ..utils.synthetic import (synthetic_compiled_tree,
                                   synthetic_mef_tree)
    from .mesh import axis_size
    from .partition import make_partitioned_propagator
    from .pipeline import make_pipe_mesh, make_pipeline_propagator
    from .quantify import (sharded_cutset_quantifier,
                           sharded_uncertainty_step)

    device = torch.device(device)
    n_ranks = mesh.size()
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "checks": {}}
    checks = out["checks"]
    wall0 = time.perf_counter()

    top, _events = synthetic_mef_tree(n_basic=24, n_gates=16, fanin=3, seed=3)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index[top.id]
    n_trials = 8 * n_ranks
    rng = np.random.default_rng(0)
    basic_p = _t(rng.uniform(0.0, 0.2, (n_trials, tree.n_basic)), device)
    house = np.zeros(tree.n_house)

    # 1) Sharded exact propagation over the trials axis (dp).
    step = sharded_uncertainty_step(tree, mesh)
    tops = gather_trials(mesh, step(shard_trials(mesh, basic_p), house))
    ref = top_event_probability(tree, basic_p, _t(house, device))
    _check(tops.shape == (n_trials,), f"uncertainty shape {tops.shape}")
    checks["uncertainty"] = _rel(tops, ref)
    _check(checks["uncertainty"] <= F64_RTOL,
           f"uncertainty rel err {checks['uncertainty']:.3e}")

    # 2) Cut-set quantification with rows split over "model" (tp), trials
    #    over "data".
    products = CutSetGenerator(tree, limit_order=6).generate(top)
    matrix = build_cutset_matrix(products, tree.n_basic)
    quantify = sharded_cutset_quantifier(matrix, mesh)
    re_l, mcub_l = quantify(shard_trials(mesh, basic_p, ("data",)))
    re_vals = gather_trials(mesh, re_l, ("data",))
    mcub_vals = gather_trials(mesh, mcub_l, ("data",))
    q = product_probabilities(matrix, basic_p)
    checks["cutset"] = max(_rel(re_vals, rare_event(q)),
                           _rel(mcub_vals, mcub(q)))
    _check(checks["cutset"] <= F64_RTOL,
           f"cut-set rel err {checks['cutset']:.3e}")

    # 3) Tensor-parallel propagation: gate rows split over "model" with a
    #    per-level halo all-gather.
    partitioned = make_partitioned_propagator(tree, mesh)
    tops_tp = gather_trials(
        mesh, partitioned(shard_trials(mesh, basic_p, ("data",)), house),
        ("data",))
    checks["partition"] = _rel(tops_tp, ref)
    _check(checks["partition"] <= F64_RTOL,
           f"partition rel err {checks['partition']:.3e}")

    # 4) Pipeline parallelism: gate levels staged over a "pipe" axis,
    #    trials microbatched, value buffers moving stage to stage.
    pp_data = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    pp_mesh = make_pipe_mesh(device, pipe=n_ranks // pp_data, data=pp_data)
    pp_tree = synthetic_compiled_tree(n_basic=64, n_gates=256, fanin=3,
                                      n_levels=8, seed=0)
    n_micro = 2 * axis_size(pp_mesh, "pipe")
    pp_trials = pp_data * n_micro * 2
    pp_fn = make_pipeline_propagator(pp_tree, pp_mesh, n_micro=n_micro)
    pp_basic = _t(rng.uniform(0.0, 0.2, (pp_trials, pp_tree.n_basic)),
                  device, torch.float32)
    pp_top = gather_trials(
        pp_mesh, pp_fn(shard_trials(pp_mesh, pp_basic, ("data",)),
                       np.zeros(0)), ("data",))
    pp_ref = top_event_probability(pp_tree, pp_basic,
                                   torch.zeros(0, device=device))
    _check(torch.equal(pp_top, pp_ref), "pipeline tops differ from the "
                                        "gather engine's")
    checks["pipeline"] = "bit-equal"

    # 5) Sharded stream step: the stream kernel on each rank's trials.
    from ..ops.stream_kernel import (compile_stream, encode_stream,
                                     stream_propagate)
    from .quantify import sharded_stream_step
    stream_tree = synthetic_compiled_tree(n_basic=96, n_gates=384, fanin=3,
                                          n_levels=6, seed=5)
    enc = encode_stream(compile_stream(stream_tree, chunk_tiles=8))
    house_s = stream_tree.house_state_vector()
    s_trials = 1024 * n_ranks
    basic_s = _t(rng.uniform(0.0, 0.2, (s_trials, stream_tree.n_basic)),
                 device, torch.float32)
    step_s = sharded_stream_step(enc, mesh, house_s)
    tops_s = gather_trials(mesh, step_s(shard_trials(mesh, basic_s)))
    _check(torch.equal(tops_s, stream_propagate(enc, basic_s, house_s)),
           "sharded stream tops differ from the unsharded kernel's")
    ref_s = top_event_probability(stream_tree, basic_s.double(),
                                  _t(house_s, device))
    checks["stream"] = _close(tops_s, ref_s, TOP_RTOL, TOP_ATOL)
    _check(checks["stream"] <= 1.0, f"stream tops {checks['stream']:.3e} "
                                    "of their tolerance")

    # 6) An event-tree-linked plant: every sequence condition conjoined
    #    into one multi-root DAG, all sequences per trial, trials sharded.
    from ..engine.event_tree_walk import walk_event_tree
    from ..io.xml import Document
    from ..mef.initializer import Initializer
    from ..settings import Settings

    n_fe = 4                       # 2^4 = 16 sequences.

    def fork(k, bits):
        if k == n_fe:
            return f'<sequence name="s{bits}"/>'
        return (f'<fork functional-event="F{k}">'
                f'<path state="success"><collect-formula>'
                f'<not><gate name="g{k}"/></not></collect-formula>'
                f'{fork(k + 1, bits)}</path>'
                f'<path state="failure"><collect-formula>'
                f'<gate name="g{k}"/></collect-formula>'
                f'{fork(k + 1, bits | (1 << k))}</path></fork>')
    xml = ('<?xml version="1.0"?><opsa-mef name="cfg4">'
           '<define-initiating-event name="IE" event-tree="ET"/>'
           '<define-event-tree name="ET">'
           + "".join(f'<define-functional-event name="F{k}"/>'
                     for k in range(n_fe))
           + "".join(f'<define-sequence name="s{s}"/>'
                     for s in range(2 ** n_fe))
           + '<initial-state>' + fork(0, 0) + '</initial-state>'
           '</define-event-tree>'
           + "".join(
               f'<define-fault-tree name="T{k}">'
               f'<define-gate name="g{k}"><or>'
               f'<basic-event name="a{k}"/><basic-event name="shared"/>'
               f'</or></define-gate>'
               f'<define-basic-event name="a{k}">'
               f'<float value="{0.05 + 0.01 * k:.2f}"/>'
               f'</define-basic-event></define-fault-tree>'
               for k in range(n_fe))
           + '<model-data><define-basic-event name="shared">'
             '<float value="0.02"/></define-basic-event></model-data>'
           '</opsa-mef>')
    et_model = Initializer.from_documents(
        [Document.from_string(xml)],
        Settings().probability_analysis(True)).model
    initiating = next(iter(et_model.initiating_events))
    outcomes = walk_event_tree(et_model, initiating)
    et_roots = [g for g in (o.conjoined_gate(f"__seq{i}__")
                            for i, o in enumerate(outcomes)) if g is not None]
    et_tree = compile_gates(et_roots)
    root_slots = [et_tree.gate_index[g.id] for g in et_roots]
    et_bp = _t(rng.uniform(0.0, 0.3, (8 * n_ranks, et_tree.n_basic)), device)
    et_house = _t(et_tree.house_state_vector(), device)

    def seq_step(bp):
        return propagate_probability(et_tree, bp, et_house)[..., root_slots]

    seq_probs = gather_trials(mesh, seq_step(shard_trials(mesh, et_bp)))
    _check(seq_probs.shape == (8 * n_ranks, len(et_roots)),
           f"sequence shape {seq_probs.shape}")
    checks["event_tree"] = _rel(seq_probs, seq_step(et_bp))
    _check(checks["event_tree"] <= F64_RTOL,
           f"sequence rel err {checks['event_tree']:.3e}")

    # 7) Importance data-parallel: the adjoint stream's gradient per
    #    trial, held to the unsharded step and to autograd through the
    #    f32 gather engine.
    from .quantify import sharded_stream_grad_step
    grad_step = sharded_stream_grad_step(enc, mesh, house_s)
    tops_g, grad_g = grad_step(shard_trials(mesh, basic_s))
    tops_g, grad_g = gather_trials(mesh, tops_g), gather_trials(mesh, grad_g)
    whole_tops, whole_grad = grad_step(basic_s)
    _check(torch.equal(tops_g, whole_tops) and torch.equal(grad_g, whole_grad),
           "sharded grad step differs from the unsharded one")
    p_ref = basic_s.clone().requires_grad_()
    with torch.enable_grad():
        ref_tops = top_event_probability(stream_tree, p_ref,
                                         _t(house_s, device, torch.float32))
        (ref_grad,) = torch.autograd.grad(ref_tops, p_ref,
                                          torch.ones_like(ref_tops))
    checks["grad_tops"] = _close(tops_g, ref_tops.detach(), TOP_RTOL,
                                 TOP_ATOL)
    checks["grad"] = _close(grad_g, ref_grad, GRAD_RTOL, GRAD_ATOL)
    _check(checks["grad_tops"] <= 1.0 and checks["grad"] <= 1.0,
           f"grad step tops {checks['grad_tops']:.3e}, gradient "
           f"{checks['grad']:.3e} of their tolerance")

    # 8) Replay-engine data parallel: the thrashing-tree engine's staged
    #    stream, each rank's trials through the replay kernel.
    from ..ops.stream_kernel import (compile_replay_stream, encode_replay,
                                     replay_propagate)
    from .quantify import sharded_replay_step
    rp_tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                      n_levels=10, seed=7)
    rp_program = compile_replay_stream(
        rp_tree, pool_slots=12, slab_bufs=3, slab_tiles=8, brs_chunk=16,
        brs_bufs=3, grs_chunk=8, grs_bufs=2, max_ops_per_segment=150)
    _check(rp_program.n_evicted > 0, "the replay schedule evicts nothing")
    rp_enc = encode_replay(rp_program)
    rp_house = rp_tree.house_state_vector()
    rp_basic = _t(rng.uniform(0.0, 0.2, (1024 * n_ranks, rp_tree.n_basic)),
                  device, torch.float32)
    rp_step = sharded_replay_step(rp_enc, mesh, rp_house)
    tops_rp = gather_trials(mesh, rp_step(shard_trials(mesh, rp_basic)))
    _check(torch.equal(tops_rp, replay_propagate(rp_enc, rp_basic, rp_house)),
           "sharded replay tops differ from the unsharded kernel's")
    ref_rp = top_event_probability(rp_tree, rp_basic.double(),
                                   _t(rp_house, device))
    checks["replay"] = _close(tops_rp, ref_rp, TOP_RTOL, TOP_ATOL)
    _check(checks["replay"] <= 1.0, f"replay tops {checks['replay']:.3e} "
                                    "of their tolerance")

    # 9) Global statistics over the mesh: two-pass mean and standard
    #    deviation, one all_reduce each.
    local = step(shard_trials(mesh, basic_p), house)
    mean = all_reduce(local.sum()) / n_trials
    std = torch.sqrt(all_reduce(((local - mean) ** 2).sum()) / n_trials)
    _check(bool(torch.isfinite(mean)) and bool(torch.isfinite(std)),
           "global statistics are not finite")
    checks["stats"] = max(_rel(mean, ref.mean()),
                          _rel(std, ref.std(correction=0)))
    _check(checks["stats"] <= F64_RTOL, f"global statistics rel err "
                                        f"{checks['stats']:.3e}")
    out.update(trials=n_trials, mean=float(mean),
               products=matrix.n_products, stream_trials=s_trials,
               replay_trials=int(rp_basic.shape[0]),
               wall_s=time.perf_counter() - wall0)
    return out
