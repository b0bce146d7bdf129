"""Torch port on the card: the CUDA kernels against their plain versions.

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode; their plain versions are what the other ``test_torch_*`` files
test here).  This file imports the port only, so it runs where neither
jax nor lxml is installed:

    python -m pytest tests/test_torch_gpu.py -q -m gpu

Tolerances: kernel and plain version bit-equal (both round every
operation on its own, the kernels being built with ``--fmad=false``);
the f64 importance path against the f64 level evaluation (or gather
autodiff, without a BDD) within 1e-12 relative to the largest value; the
multi-root kernel within 1e-12 absolute of the f64 gather engine (count
gates round their DP in another order);
float32 propagator tops against the f64 gather engine within 1e-5
relative; the Monte Carlo estimate on the card equal to the CPU's to the
bit (the same Philox words, exact bitwise propagation); the gather and
block-gather direct kernels bit-equal to the float32 gather engine, the
block-gather log kernel within 1e-6 relative of its plain version (the
card's ``logf``/``expf`` against torch's) and within 1e-5 of the f64
gather engine; the threefry kernels (``csrc/prng.cu``) bit-equal to their
plain versions on the card, one ``draw_standard`` launch per tape and one
``draw_gamma`` launch per gamma or beta deviate.
"""

import numpy as np
import pytest
import torch

from canopy_tpu_torch.compiler.modules import build_modular_bdd
from canopy_tpu_torch.compiler.schedule import StreamProgram
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.bdd_eval import make_modular_evaluator
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.engine.propagate import (make_propagator,
                                               top_event_probability)
from canopy_tpu_torch.ops import adjoint_kernel as tak
from canopy_tpu_torch.ops import fused_kernel as tfk
from canopy_tpu_torch.ops import prng
from canopy_tpu_torch.ops import stream_kernel as tsk
from canopy_tpu_torch.ops.prng import fold_in, prng_key
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils.profiling import counters

from torch_parity import (assert_sequence_stats,  # noqa: F401
                          cuda_device, fixture_inputs, fixture_path,
                          launches_since, load_tree, overwriting_program)

pytestmark = pytest.mark.gpu


def _programs():
    """(label, encoded program, house states) covering every op kind."""
    out = [("overwriting", tsk.encode_stream(
        overwriting_program(StreamProgram)), [])]
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_noncoherent")
    out.append(("noncoherent-tree",
                tsk.encode_stream(tsk.compile_stream(tree)),
                tree.house_state_vector()))
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    bdd = max(build_modular_bdd(tree).chain, key=lambda c: c[0].n_nodes)[0]
    out.append(("ccf-bdd", tsk.encode_stream(tsk.compile_bdd_stream(bdd)),
                []))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain(cuda_device, dtype):  # noqa: F811
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for label, enc, house in _programs():
        staged = (torch.rand((enc.n_basic, 1000), generator=gen,
                             device=cuda_device, dtype=torch.float64)
                  * 0.3).to(dtype)
        ct = torch.rand(1000, generator=gen, device=cuda_device,
                        dtype=torch.float64).to(dtype)
        h = tsk.house_tensor(enc, house, cuda_device, dtype)
        top, log = tsk.stream_forward(enc, staged, house, with_log=True)
        ptop, plog = tsk.stream_forward_plain(enc, staged, h, True)
        assert torch.equal(top, ptop) and torch.equal(log, plog), label
        assert torch.equal(tsk.stream_forward(enc, staged, house)[0], top)
        grad = tak.stream_backward(enc, staged, house, log, ct)
        pgrad = tak.stream_backward_plain(enc, staged, h, plog, ct)
        assert torch.equal(grad, pgrad), label


def test_launch_counts_and_wrapper_checks(cuda_device):  # noqa: F811
    label, enc, house = _programs()[1]
    start = counters()
    staged = torch.rand((enc.n_basic, 64), device=cuda_device)
    top, log = tsk.stream_forward(enc, staged, house, with_log=True)
    tak.stream_backward(enc, staged, house, log, torch.ones_like(top))
    tsk.stream_forward(enc, staged, house)
    # Every other kernel's count stays 0, whatever kernels exist.
    assert launches_since(start) == {
        "stream": 1, "stream_log": 1, "adjoint": 1}
    with pytest.raises(LogicError):
        tsk.stream_forward(enc, staged.half(), house)


def test_analysis_on_cuda_matches_cpu(cuda_device):  # noqa: F811
    """Probability (f64 level evaluation on both) and importance (the
    f64 adjoint kernel on CUDA, autograd of the level evaluation on the
    CPU) agree."""
    settings = (Settings().algorithm("bdd").probability_analysis(True)
                .importance_analysis(True))
    model = Initializer([fixture_path("aralia_like_medium")],
                        settings).model
    start = counters()
    (gpu,) = RiskAnalysis(model, settings, "cuda").run().fault_trees
    launched = launches_since(start)
    assert launched["stream_log"] > 0 and launched["adjoint"] > 0
    (cpu,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    assert gpu.probability == cpu.probability
    mif = np.array([r["MIF"] for r in gpu.importance])
    want = np.array([r["MIF"] for r in cpu.importance])
    np.testing.assert_allclose(mif, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_uncertainty_streams_on_cuda(cuda_device):  # noqa: F811
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    modular = build_modular_bdd(tree)
    ev = make_modular_evaluator(modular, cuda_device)
    assert ev.method == "bdd-stream-f32"
    p = torch.rand((4096, tree.n_basic), device=cuda_device,
                   dtype=torch.float64) * 0.02
    start = counters()
    with torch.no_grad():
        got = ev(p)
    # One launch per module whose root is not a constant, small ones too.
    assert launches_since(start)["stream"] == sum(
        1 for bdd, _slot in modular.chain if bdd.resolved_root() > 1) == 2
    from canopy_tpu_torch.compiler.modules import modular_probability
    want = modular_probability(modular, p)
    assert float(((got.double() - want).abs() / want).max()) <= 1e-5


def test_event_tree_on_cuda(cuda_device, tmp_path):  # noqa: F811
    """Sequences on the card: point values equal to the CPU's within
    1e-12 relative; sequence uncertainty launches the stream kernel once
    per root (beside the fault trees' own uncertainty launches), and each
    sequence's mean is within 1e-5 relative of the f64 level evaluation
    of the same (redrawn) samples."""
    import zlib

    from canopy_tpu_torch.compiler.bdd import build_bdd_multi
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.compiler.graph import (compile_fault_tree,
                                                 compile_gates)
    from canopy_tpu_torch.engine.bdd_eval import bdd_probability
    from canopy_tpu_torch.engine.event_tree_walk import walk_event_tree
    from canopy_tpu_torch.utils.scale_models import event_tree_scale_xml
    path = tmp_path / "scale16.xml"
    path.write_text(event_tree_scale_xml(n_fe=4, deviates=True,
                                         house_flip=True))
    settings = (Settings().probability_analysis(True)
                .uncertainty_analysis(True).num_trials(4096).seed(7))
    model = Initializer([str(path)], settings).model
    cpu = RiskAnalysis(model, settings, "cpu").run().sequences
    start = counters()
    gpu = RiskAnalysis(model, settings, "cuda").run().sequences
    # One launch per sequence root, and one per module of the four fault
    # trees' own uncertainty analyses.
    n_modules = 0
    for fault_tree in model.fault_trees:
        ft_tree = compile_fault_tree(fault_tree)
        n_modules += sum(
            1 for bdd, _slot in build_modular_bdd(
                ft_tree, house_states=ft_tree.house_state_vector()).chain
            if bdd.resolved_root() > 1)
    assert launches_since(start)["stream"] == len(gpu) + n_modules == 16 + 4
    assert {s.uncertainty["method"] for s in gpu} == {"bdd-stream-f32"}
    (initiating,) = model.initiating_events
    outcomes = walk_event_tree(model, initiating)
    gates = [o.conjoined_gate(f"__seq{i}__") for i, o in enumerate(outcomes)]
    tree = compile_gates(gates)
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    key = fold_in(prng_key(7), zlib.crc32(b"IE") & 0x7FFFFFFF)
    basic = torch.clamp(tape.sample(key, 4096, settings.mission_time(),
                                    cuda_device), 0.0, 1.0)
    for s_gpu, s_cpu, outcome, gate in zip(gpu, cpu, outcomes, gates):
        assert abs(s_gpu.probability - s_cpu.probability) <= \
            1e-12 * s_cpu.probability
        house = tree.house_state_vector()
        for event_id, state in outcome.house_states.items():
            house[tree.house_index[event_id] - tree.n_basic] = float(state)
        (bdd,) = build_bdd_multi(tree, [tree.gate_index[gate.id]],
                                 house_states=house)
        want = float(bdd_probability(bdd, basic).mean())
        assert abs(s_gpu.uncertainty["mean"] - want) <= 1e-5 * want


@pytest.mark.parametrize("name,tree_name", [
    ("torch_slice_plant", "slice"), ("aralia_like_large", None),
    ("aralia_like_nested_count", None), ("demo_plant", "Cooling")])
def test_fused_kernels_match_plain(cuda_device, name,  # noqa: F811
                                   tree_name):
    """The fused kernel (live rows in device memory, the ring kernel) on
    ``chip_smoke.py`` phase 4's four trees, at 2^20, 100,003 and one
    trial and a ragged 4,099, through both entry points, bit-equal to
    plain."""
    _m, tree = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
    enc = tfk.encode_fused(tree)
    house = tree.house_state_vector()
    h32 = tsk.house_tensor(enc, house, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for n in (1 << 20, 100_003, 4099, 1):
        staged = torch.rand((tree.n_basic, n), generator=gen,
                            device=cuda_device) * 0.3
        want = tfk.fused_forward_plain(enc, staged, h32)
        for tiled in (False, True):
            got = tfk.fused_forward(enc, staged, house, tiled)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, n, tiled)


def test_propagator_dispatch_on_cuda(cuda_device):  # noqa: F811
    """Auto runs the stream kernel on every tree; ``engine="fused"`` still
    runs the tiled and lane-row kernels where the trees fit them."""
    from canopy_tpu_torch.utils.synthetic import synthetic_hierarchical_tree
    big = synthetic_hierarchical_tree(n_basic=16384, branching=8,
                                      share_fraction=0.1, n_shared=32,
                                      seed=0)
    slice_tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                           tree_name="slice")[1]
    large = load_tree("canopy_tpu_torch", "aralia_like_large")[1]
    cases = [(slice_tree, "auto", "stream"), (large, "auto", "stream"),
             (big, "auto", "stream"), (slice_tree, "fused", "fused_tiled"),
             (large, "fused", "fused")]
    for tree, request, engine in cases:
        fn = make_propagator(tree, cuda_device, engine=request)
        assert fn.engine == engine
        p = torch.rand((3000, tree.n_basic), device=cuda_device,
                       dtype=torch.float64) * 0.02
        start = counters()
        got = fn(p)
        assert launches_since(start)[engine] == 1
        want = make_propagator(tree, cuda_device, engine="gather")(p)
        assert float(((got.double() - want).abs() / want).max()) <= 1e-5


def test_pdag_analysis_on_cuda_matches_cpu(cuda_device):  # noqa: F811
    """Without a BDD: the f64 gather probability, importance through the
    tree's f64 stream and adjoint kernels, uncertainty through the stream
    kernel; against the CPU run (gather autodiff)."""
    settings = (Settings().algorithm("pdag").approximation("none")
                .probability_analysis(True).importance_analysis(True)
                .uncertainty_analysis(True).num_trials(5000).seed(3)
                .skip_products(True))
    # The slice model: its basic events carry lognormal deviates, so the
    # analysis samples them (constant-only models skip uncertainty).
    model = Initializer([fixture_path("torch_slice_plant")],
                        settings).model
    start = counters()
    (gpu,) = RiskAnalysis(model, settings, "cuda").run().fault_trees
    launched = launches_since(start)
    assert launched["stream_log"] == 1 and launched["adjoint"] == 1
    assert launched["stream"] == 1 and launched["fused_tiled"] == 0
    (cpu,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    assert abs(gpu.probability - cpu.probability) <= \
        1e-12 * abs(cpu.probability)
    mif = np.array([r["MIF"] for r in gpu.importance])
    want = np.array([r["MIF"] for r in cpu.importance])
    np.testing.assert_allclose(mif, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert "method" not in gpu.uncertainty


#: The thrash-shaped replay schedule of the JAX package's tests: a tiny
#: pool and short segments force evictions, slab reads, refills and
#: gate-stream reads on a 900-gate tree.
THRASH = dict(brs_chunk=16, brs_bufs=3, grs_chunk=8, grs_bufs=2,
              slab_bufs=3, slab_tiles=8, max_ops_per_segment=150,
              pool_slots=12, hoist_events=8, n_refill_sems=4,
              n_flush_sems=2)
ADJOINT = dict(tct=16, tape_bufs=3, tape_slab=8, gcot_bufs=2, icot_bufs=2,
               inj_chunk=4, inj_bufs=2, side_cap=32, **THRASH)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replay_kernels_match_plain(cuda_device, dtype):  # noqa: F811
    """Replay forward (with a resident tier), taped forward and backward,
    each bit-equal to its plain version at 1 and 1,000 trials."""
    from canopy_tpu_torch.ops import replay_adjoint_kernel as trk
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                   n_levels=10, seed=0)
    fwd = tsk.encode_replay(tsk.compile_replay_stream(
        tree, **dict(THRASH, resident_tiles=32)))
    adj = tsk.encode_replay(trk.compile_replay_adjoint(tree,
                                                       **ADJOINT).base)
    assert fwd.res_rows and fwd.n_evicted and adj.n_evicted
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    h = torch.zeros(1, dtype=dtype, device=cuda_device)
    for n in (1, 1000):
        p = (torch.rand((n, tree.n_basic), generator=gen, device=cuda_device,
                        dtype=torch.float64) * 0.6).to(dtype)
        staged = tsk.stage_replay(fwd, p, dtype)
        top, _ = tsk.replay_forward(fwd, staged, [])
        assert torch.equal(top, tsk.replay_forward_plain(fwd, staged, h)[0])
        staged = tsk.stage_replay(adj, p, dtype)
        ct = torch.rand(n, generator=gen, device=cuda_device,
                        dtype=torch.float64).to(dtype) + 0.5
        top, vlog = trk.replay_tape_forward(adj, staged, [])
        ptop, plog = tsk.replay_forward_plain(adj, staged, h, True)
        assert torch.equal(top, ptop) and torch.equal(vlog, plog), n
        grad = trk.replay_adjoint_backward(adj, staged, [], vlog, ct)
        want = trk.replay_backward_plain(adj, staged, h, plog, ct)
        assert torch.equal(grad, want), n


def test_replay_engine_on_cuda(cuda_device):  # noqa: F811
    """``engine="replay"`` and its staged pair launch the replay kernel
    (never another engine) and agree with the f64 gather engine."""
    from canopy_tpu_torch.engine.propagate import make_staged_propagator
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=512, n_gates=4096, fanin=4,
                                   n_levels=12, seed=1)
    p = torch.rand((3000, tree.n_basic), device=cuda_device,
                   dtype=torch.float64) * 0.05
    fn = make_propagator(tree, cuda_device, engine="replay")
    stage, run = make_staged_propagator(tree, cuda_device, engine="replay")
    start = counters()
    got = fn(p)
    assert torch.equal(run(stage(p)), got)
    assert fn.engine == run.engine == "replay"
    launched = launches_since(start)
    assert launched["replay"] == 2 and launched["stream"] == 0
    want = make_propagator(tree, cuda_device, engine="gather")(p)
    assert float(((got.double() - want).abs() / want).max()) <= 1e-5


def test_bernoulli_kernel_matches_plain(cuda_device):  # noqa: F811
    """The Philox kernel bit-equal to its plain version, at p of 0 and 1,
    in a chunk that starts at a later word, and under a seed beyond 32
    bits."""
    from canopy_tpu_torch.ops.bernoulli_kernel import (packed_bernoulli,
                                                       packed_bernoulli_plain)
    p = torch.tensor([0.0, 1.0, 0.3, 1e-7, 0.999, 0.5], dtype=torch.float64,
                     device=cuda_device)
    for seed, n_trials, word0 in ((7, 32 * 1000, 0), (7, 32 * 333, 4097),
                                  ((5 << 32) + 9, 32 * 64, 0)):
        start = counters()
        got = packed_bernoulli(seed, p, n_trials, word0)
        assert launches_since(start)["bernoulli"] == 1
        want = packed_bernoulli_plain(seed, p, n_trials, word0)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), packed_bernoulli(seed, p.cpu(),
                                                       n_trials, word0))
    assert (got[0] == 0).all() and (got[1] == -1).all()


def test_monte_carlo_on_cuda_equals_the_cpu(cuda_device):  # noqa: F811
    """The Monte Carlo branch on the card gives the CPU's estimate to the
    bit (same Philox words, exact bitwise propagation and popcount), and
    launched the Bernoulli kernel."""
    settings = (Settings().probability_analysis(True)
                .approximation("monte-carlo").num_trials(65_536).seed(3)
                .skip_products(True))
    out = {}
    for device in ("cpu", cuda_device):
        model = Initializer([fixture_path("aralia_like_large")],
                            settings).model
        start = counters()
        (ft,) = RiskAnalysis(model, settings, device).run().fault_trees
        out[str(device)] = (ft.probability, ft.mc_std_error,
                            launches_since(start)["bernoulli"])
    (p_cpu, se_cpu, n_cpu), (p_gpu, se_gpu, n_gpu) = out.values()
    assert (p_cpu, se_cpu) == (p_gpu, se_gpu)
    assert n_cpu == 0 and n_gpu >= 1


def test_spill_kernel_matches_plain(cuda_device):  # noqa: F811
    """The spill kernel bit-equal to its plain version under a forced
    small schedule (staging spills, evictions, refills from the staged
    input and from scratch, segment boundaries), in float32 and float64,
    and its tops bit-equal to the stream kernel's on the default one."""
    from canopy_tpu_torch.compiler.spill import build_spill_schedule
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=96, n_gates=900, fanin=4,
                                   n_levels=10, seed=0)
    small = tsk.encode_spill(build_spill_schedule(
        tree, chunk_tiles=8, pool_slots=12, slab_tiles=4,
        max_ops_per_segment=150, hoist_events=6))
    assert all(small.counts.values()), small.counts
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for dtype in (torch.float32, torch.float64):
        p = (torch.rand((1000, tree.n_basic), generator=gen,
                        device=cuda_device, dtype=torch.float64)
             * 0.6).to(dtype)
        staged = tsk.stage_basic(small, p, dtype)
        h = tsk.house_tensor(small, [], cuda_device, dtype)
        assert torch.equal(tsk.spill_forward(small, staged, []),
                           tsk.spill_forward_plain(small, staged, h))
    enc = tsk.encode_spill(tsk.compile_spill_stream(tree))
    senc = tsk.tree_stream_encoding(tree)
    p = p.float()
    assert torch.equal(tsk.spill_propagate(enc, p, []),
                       tsk.stream_propagate(senc, p, []))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_spill_kernel_on_the_65k_shape(cuda_device, dtype):  # noqa: F811
    """The spill kernel (the ring kernel) on ``bench.py``'s 65k replay
    tree at its default sizing, 65,536 trials, bit-equal to plain and to
    the stream kernel; and ``chip_smoke.py``'s forced small schedule on
    the 16k tree (every op kind, ring pads at every depth), bit-equal to
    plain; float32 and float64."""
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=8192, n_gates=65536, fanin=4,
                                   n_levels=14, seed=0)
    enc = tsk.encode_spill(tsk.compile_spill_stream(tree))
    assert enc.counts["evictions"] and enc.counts["scratch_refills"]
    gen = torch.Generator(device=cuda_device).manual_seed(65)
    p = (torch.rand((65_536, tree.n_basic), generator=gen,
                    device=cuda_device, dtype=torch.float64)
         * 0.05).to(dtype)
    staged = tsk.stage_basic(enc, p, dtype)
    h = tsk.house_tensor(enc, [], cuda_device, dtype)
    top = tsk.spill_forward(enc, staged, [])
    assert torch.equal(top, tsk.spill_forward_plain(enc, staged, h))
    senc = tsk.tree_stream_encoding(tree)
    assert torch.equal(top, tsk.stream_forward(
        senc, tsk.stage_basic(senc, p, dtype), [])[0])
    del staged, p
    tree16 = synthetic_compiled_tree(n_basic=8192, n_gates=16384, fanin=4,
                                     n_levels=14, seed=0)
    small = tsk.encode_spill(tsk.compile_spill_stream(
        tree16, pool_slots=16, chunk_tiles=256, slab_tiles=8,
        max_ops_per_segment=2048, hoist_events=16))
    assert all(small.counts.values()), small.counts
    p = (torch.rand((1024, tree16.n_basic), generator=gen,
                    device=cuda_device, dtype=torch.float64)
         * 0.05).to(dtype)
    staged = tsk.stage_basic(small, p, dtype)
    assert torch.equal(tsk.spill_forward(small, staged, []),
                       tsk.spill_forward_plain(small, staged, h))


def test_spill_engine_on_cuda(cuda_device):  # noqa: F811
    """``engine="spill"`` launches the spill kernel (never another engine)
    and agrees with the f64 gather engine."""
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=512, n_gates=4096, fanin=4,
                                   n_levels=12, seed=1)
    p = torch.rand((3000, tree.n_basic), device=cuda_device,
                   dtype=torch.float64) * 0.05
    fn = make_propagator(tree, cuda_device, engine="spill")
    start = counters()
    got = fn(p)
    assert fn.engine == "spill"
    launched = launches_since(start)
    assert launched["spill"] == 1 and launched["stream"] == 0
    want = make_propagator(tree, cuda_device, engine="gather")(p)
    assert float(((got.double() - want).abs() / want).max()) <= 1e-5


def test_spill_program_beyond_shared_memory_raises(cuda_device):  # noqa: F811
    """A pool wider than one block's shared memory is refused before any
    launch, by the sizing and by the wrapper."""
    from canopy_tpu_torch.compiler.spill import build_spill_schedule
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=64, n_gates=256, fanin=4,
                                   n_levels=5, seed=1)
    with pytest.raises(LogicError, match="shared memory"):
        tsk.compile_spill_stream(tree, pool_slots=tsk.SPILL_SLOTS + 1)
    enc = tsk.encode_spill(build_spill_schedule(
        tree, pool_slots=tsk.SPILL_SLOTS + 1))
    start = counters()
    with pytest.raises(LogicError, match="shared memory"):
        tsk.spill_forward(enc, torch.zeros((enc.n_basic, 64),
                                           device=cuda_device), [])
    assert launches_since(start)["spill"] == 0


def _reordered_tree(n_basic: int):
    from canopy_tpu_torch.compiler.reorder import (locality_reorder,
                                                   random_shuffle)
    from canopy_tpu_torch.utils.synthetic import synthetic_hierarchical_tree
    tree = synthetic_hierarchical_tree(n_basic=n_basic, branching=8,
                                       share_fraction=0.1, n_shared=128,
                                       seed=0)
    return locality_reorder(random_shuffle(tree, seed=1).tree,
                            hot_first=True).tree


def test_gather_kernel_matches_plain(cuda_device):  # noqa: F811
    """Uniform fan-in and a ragged tree (padded positions masked), one
    launch per product block, bit-equal to plain and to the float32
    gather engine."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.ops import gather_kernel as tgk
    from canopy_tpu_torch.utils.synthetic import (synthetic_compiled_tree,
                                                  synthetic_mef_tree)
    top, _ = synthetic_mef_tree(n_basic=32, n_gates=40, fanin=4, seed=3)
    ragged = compile_gates([top])
    ragged.top_index = ragged.gate_index[top.id]
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for tree in (ragged, _reordered_tree(4096),
                 synthetic_compiled_tree(n_basic=256, n_gates=1000, fanin=4,
                                         n_levels=6, seed=3)):
        p = torch.rand((2048, tree.n_basic), generator=gen,
                       device=cuda_device) * 0.5
        start = counters()
        got = tgk.gather_propagate(tree, p)
        assert launches_since(start)["gather"] == sum(
            1 for lv in tree.levels for b in lv.prods if b.n_gates)
        assert torch.equal(got, tgk.gather_forward_plain(tree, p))
        assert torch.equal(got, top_event_probability(tree, p))


@pytest.mark.parametrize("t_tile", [None, 512])
def test_block_gather_kernels_match_plain(cuda_device, t_tile):  # noqa: F811
    """Both modes, one launch per level, at the default 128-trial blocks
    and at 512-trial blocks (each thread loops over four trials).  Hard
    0/1 inputs stay exact in log mode."""
    from canopy_tpu_torch.ops import block_gather as tbg
    tree = _reordered_tree(4096)
    program = tbg.compile_block_gather(tree)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    p = torch.rand((2048, tree.n_basic), generator=gen,
                   device=cuda_device) * 0.4
    ref = top_event_probability(tree, p)
    for mode in ("log", "direct"):
        start = counters()
        got = tbg.block_gather_propagate(program, p, t_tile=t_tile,
                                         mode=mode)
        assert launches_since(start)[f"block_{mode}"] == len(program.levels)
        plain = tbg.block_gather_forward_plain(program, p, mode)
        if mode == "direct":
            assert torch.equal(got, plain) and torch.equal(got, ref)
        else:
            assert float(((got - plain).abs() / plain).max()) <= 1e-6
    hard = (torch.rand((1024, tree.n_basic), generator=gen,
                       device=cuda_device) < 0.5).float()
    assert torch.equal(tbg.block_gather_propagate(program, hard,
                                                  t_tile=t_tile),
                       top_event_probability(tree, hard))


def test_block_engine_on_cuda(cuda_device):  # noqa: F811
    """``engine="block"`` launches the log kernel once per level (never
    another engine) and agrees with the f64 gather engine."""
    tree = _reordered_tree(4096)
    fn = make_propagator(tree, cuda_device, engine="block")
    p = torch.rand((4096, tree.n_basic), device=cuda_device,
                   dtype=torch.float64) * 0.05
    start = counters()
    got = fn(p)
    assert fn.engine == "block" and got.dtype == torch.float32
    assert launches_since(start) == {
        "block_log": len(tree.levels)}
    want = make_propagator(tree, cuda_device, engine="gather")(p)
    assert float(((got.double() - want).abs() / want).max()) <= 1e-5


def test_bsr_on_cuda_refuses_tf32(cuda_device):  # noqa: F811
    """BSR on the card within 1e-5 of the float32 gather engine in full
    float32, and a ``LogicError`` when a caller has turned TF32 on."""
    from canopy_tpu_torch.ops.bsr_propagate import (bsr_top_probability,
                                                    compile_bsr)
    tree = _reordered_tree(4096)
    program = compile_bsr(tree)
    p = torch.rand((512, tree.n_basic), device=cuda_device) * 0.4
    got = bsr_top_probability(program, p)
    want = top_event_probability(tree, p)
    assert float(((got - want).abs() / want).max()) <= 1e-5
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(LogicError):
            bsr_top_probability(program, p)
    finally:
        torch.set_float32_matmul_precision(before)
    assert not torch.backends.cuda.matmul.allow_tf32


def _slice_module():
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    return max(build_modular_bdd(tree).chain, key=lambda c: c[0].n_nodes)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_kernel_matches_plain(cuda_device, dtype):  # noqa: F811
    """The step kernel on the BDD slice's module, in its batched and its
    depth-first order, at a ragged trial count: bit-equal to plain."""
    bdd = _slice_module()
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    for enc in (tsk.bdd_stream_encoding(bdd),
                tsk.encode_stream(tsk.compile_bdd_stream(bdd))):
        values = (torch.rand((100_003, int(enc.staged_cols.max()) + 1),
                             generator=gen, device=cuda_device,
                             dtype=torch.float64) * 0.05).to(dtype)
        staged = tsk.stage_basic(enc, values, dtype)
        want = tsk.stream_forward_plain(
            enc, staged, tsk.house_tensor(enc, [], cuda_device, dtype))[0]
        start = counters()
        assert torch.equal(tsk.stream_forward(enc, staged, [])[0], want)
        assert tsk.stream_variant(enc) == "steps"
        assert launches_since(start) == {"stream": 1}


def test_step_kernel_offsets_above_2_31(cuda_device):  # noqa: F811
    """A small BDD at about 2^29 trials, so that both the staged input's
    and the pool's row offsets pass 2^31 elements: the step kernel's
    64-bit offsets.  The trials repeat a 4,096-trial pattern, so every
    top must equal the plain version's on the pattern."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    events = [BasicEvent(f"v{i}") for i in range(6)]
    top = Gate("top")
    top.formula = Formula(Connective.ATLEAST, [Arg(e) for e in events],
                          min_number=3)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    (bdd, _slot), = build_modular_bdd(tree).chain
    enc = tsk.encode_stream(tsk.compile_bdd_stream(bdd))
    assert tsk.stream_variant(enc) == "steps"
    pattern, reps = 4096, 131_073
    T = pattern * reps + 77
    assert enc.n_basic * T >= 1 << 31
    assert (enc.pool_slots + 1) * T >= 1 << 31
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    small = torch.rand((enc.n_basic, pattern), generator=gen,
                       device=cuda_device) * 0.5
    want = tsk.stream_forward_plain(
        enc, small, tsk.house_tensor(enc, [], cuda_device))[0]
    staged = torch.empty((enc.n_basic, T), device=cuda_device)
    staged[:, :pattern * reps].view(-1, reps, pattern).copy_(
        small[:, None, :])
    staged[:, pattern * reps:] = small[:, :77]
    got = tsk.stream_forward(enc, staged, [])[0]
    del staged
    assert torch.equal(got[:pattern * reps].view(reps, pattern),
                       want.expand(reps, pattern))
    assert torch.equal(got[pattern * reps:], want[:77])
    del got
    torch.cuda.empty_cache()


def test_propagator_names_its_stream_variant(cuda_device):  # noqa: F811
    """The 65k tree's program (5,029 pool slots): the propagator names
    its stream variant, the one-trial-per-thread kernel, which is
    bit-equal to plain."""
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=8192, n_gates=65536, fanin=4,
                                   n_levels=14, seed=0)
    fn = make_propagator(tree, cuda_device)
    assert fn.engine == "stream" and fn.stream_variant == "ops"
    enc = tsk.tree_stream_encoding(tree)
    p = torch.rand((2048, tree.n_basic), device=cuda_device) * 0.05
    staged = tsk.stage_basic(enc, p)
    want = tsk.stream_forward_plain(
        enc, staged, tsk.house_tensor(enc, [], cuda_device))[0]
    start = counters()
    assert torch.equal(fn(p), want)
    assert tsk.stream_variant(enc) == "ops"
    assert launches_since(start) == {"stream": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_trials", [1, 1024])
def test_level_kernels_match_plain(cuda_device, n_trials,
                                   dtype):  # noqa: F811
    """The level-parallel logged forward and adjoint on the BDD slice's
    module and the slice tree's program: bit-equal to the sequential
    plain versions."""
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    for enc, house in ((tsk.bdd_stream_encoding(_slice_module()), []),
                       (tsk.tree_stream_encoding(tree),
                        tree.house_state_vector())):
        staged = (torch.rand((enc.n_basic, n_trials), generator=gen,
                             device=cuda_device, dtype=torch.float64)
                  * 0.05).to(dtype)
        ct = (torch.rand(n_trials, generator=gen, device=cuda_device,
                         dtype=torch.float64) + 0.5).to(dtype)
        h = tsk.house_tensor(enc, house, cuda_device, dtype)
        ptop, plog = tsk.stream_forward_plain(enc, staged, h, True)
        pgrad = tak.stream_backward_plain(enc, staged, h, plog, ct)
        top, log = tsk.stream_forward(enc, staged, house, with_log=True)
        grad = tak.stream_backward(enc, staged, house, log, ct)
        assert torch.equal(top, ptop) and torch.equal(log, plog)
        assert torch.equal(grad, pgrad)


def test_wide_atleast_on_cuda(cuda_device):  # noqa: F811
    """atleast 2 of 130 at p = 0.01: the auto propagator, uncertainty and
    stream importance on the card within 1e-6 relative of the CPU f64
    values (the count DP absorbing at 2, not 132 states)."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.engine.importance import make_stream_importance_fn
    from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    from canopy_tpu_torch.mef.expr.constant import ConstantExpression
    events = []
    for i in range(130):
        e = BasicEvent(f"c{i:03d}")
        e.expression = ConstantExpression(0.01)
        events.append(e)
    top = Gate("top")
    top.formula = Formula(Connective.ATLEAST, [Arg(e) for e in events],
                          min_number=2)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    p = torch.full((4, 130), 0.01, dtype=torch.float64)
    want = float(make_propagator(tree, "cpu")(p)[0])
    assert abs(want - 0.3737098441591238) <= 1e-15
    fn = make_propagator(tree, cuda_device)
    assert fn.engine == "stream"
    got = fn(p.to(cuda_device)).double().cpu()
    assert float((got - want).abs().max()) <= 1e-6 * want
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    unc = uncertainty_analysis(tree, tape, 7, 4096, 8760.0, cuda_device)
    assert abs(unc.mean - want) <= 1e-6 * want
    grads = []
    for device in ("cpu", cuda_device):
        q = torch.full((130,), 0.01, dtype=torch.float64, device=device,
                       requires_grad=True)
        make_stream_importance_fn(tree, None, device)(q).backward()
        grads.append(q.grad.cpu())
    assert float((grads[1] - grads[0]).abs().max()) <= \
        1e-6 * float(grads[0].abs().max())


def _cardinality_tree(n: int, lo: int, hi: int):
    """cardinality [lo, hi] over n basic events, every fifth argument
    complemented (``tests/test_torch_count_window.py``'s gate)."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.mef.event import (Arg, BasicEvent, Connective,
                                            Formula, Gate)
    from canopy_tpu_torch.mef.expr.constant import ConstantExpression
    events = []
    for i in range(n):
        e = BasicEvent(f"c{i:03d}")
        e.expression = ConstantExpression(0.01)
        events.append(e)
    top = Gate("top")
    top.formula = Formula(Connective.CARDINALITY,
                          [Arg(e, complement=i % 5 == 4)
                           for i, e in enumerate(events)],
                          min_number=lo, max_number=hi)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def test_residual_window_kernels_match_plain(cuda_device):  # noqa: F811
    """cardinality [130, 140] over 300 inputs (142 DP states, beyond the
    kernels' local arrays: the device-memory DP scratch): every kernel
    that evaluates COUNT ops bit-equal to its plain version, forward and
    backward, float32 at 1,000 trials and float64 at one."""
    from canopy_tpu_torch.ops import replay_adjoint_kernel as trk
    tree = _cardinality_tree(300, 130, 140)
    senc = tsk.tree_stream_encoding(tree)
    fenc = tfk.encode_fused(tree)
    renc = tsk.encode_replay(tsk.compile_replay_stream(tree, grs_chunk=512))
    aenc = renc    # no resident tier: the backward takes it
    spenc = tsk.encode_spill(tsk.compile_spill_stream(tree))
    for enc in (senc, fenc, renc, spenc):
        assert enc.max_count_states == 142 > tsk.MAX_COUNT_STATES
    gen = torch.Generator(device=cuda_device).manual_seed(142)
    start = counters()
    for dtype, n in ((torch.float32, 1000), (torch.float64, 1)):
        p = (torch.rand((n, 300), generator=gen, device=cuda_device,
                        dtype=torch.float64) * 0.2 + 0.35).to(dtype)
        h = torch.zeros(1, dtype=dtype, device=cuda_device)
        ct = torch.rand(n, generator=gen, device=cuda_device,
                        dtype=torch.float64).to(dtype) + 0.5
        staged = tsk.stage_basic(senc, p, dtype)
        top, _ = tsk.stream_forward(senc, staged, [])
        assert torch.equal(top, tsk.stream_forward_plain(senc, staged, h)[0])
        top, log = tsk.stream_forward(senc, staged, [], with_log=True)
        ptop, plog = tsk.stream_forward_plain(senc, staged, h, True)
        assert torch.equal(top, ptop) and torch.equal(log, plog)
        assert torch.equal(tak.stream_backward(senc, staged, [], log, ct),
                           tak.stream_backward_plain(senc, staged, h, plog,
                                                     ct))
        if dtype == torch.float32:
            fstaged = tfk.tile_trials(p)
            want = tfk.fused_forward_plain(fenc, fstaged, h)
            for tiled in (True, False):
                assert torch.equal(tfk.fused_forward(fenc, fstaged, [],
                                                     tiled), want)
        rstaged = tsk.stage_replay(renc, p, dtype)
        assert torch.equal(tsk.replay_forward(renc, rstaged, [])[0],
                           tsk.replay_forward_plain(renc, rstaged, h)[0])
        astaged = tsk.stage_replay(aenc, p, dtype)
        top, vlog = trk.replay_tape_forward(aenc, astaged, [])
        ptop, plog = tsk.replay_forward_plain(aenc, astaged, h, True)
        assert torch.equal(top, ptop) and torch.equal(vlog, plog)
        assert torch.equal(
            trk.replay_adjoint_backward(aenc, astaged, [], vlog, ct),
            trk.replay_backward_plain(aenc, astaged, h, plog, ct))
        sstaged = tsk.stage_basic(spenc, p, dtype)
        assert torch.equal(tsk.spill_forward(spenc, sstaged, []),
                           tsk.spill_forward_plain(spenc, sstaged, h))
    for name in ("stream", "stream_log", "adjoint", "fused_tiled", "fused",
                 "replay", "replay_tape", "replay_bwd", "spill"):
        assert launches_since(start)[name] > 0, name


@pytest.mark.parametrize("n_trials", [33, 20_000, 65_536])
def test_replay_ring_widths_match_plain(cuda_device, n_trials):  # noqa: F811
    """The ring forward at the block widths its plan picks for 33, 20,000
    and 65,536 trials (32, 128 and 256 trials per block, a ragged last
    block), float32, bit-equal to plain and to the stream kernel."""
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    tree = synthetic_compiled_tree(n_basic=512, n_gates=4096, fanin=4,
                                   n_levels=12, seed=1)
    enc = tsk.encode_replay(tsk.compile_replay_stream(tree))
    plan = tsk.replay_plan(enc, torch.float32, n_trials)
    assert plan.width == {33: 32, 20_000: 128, 65_536: 256}[n_trials]
    gen = torch.Generator(device=cuda_device).manual_seed(n_trials)
    p = torch.rand((n_trials, tree.n_basic), generator=gen,
                   device=cuda_device) * 0.05
    staged = tsk.stage_replay(enc, p)
    h = torch.zeros(1, device=cuda_device)
    top, _ = tsk.replay_forward(enc, staged, [])
    assert torch.equal(top, tsk.replay_forward_plain(enc, staged, h)[0])
    senc = tsk.tree_stream_encoding(tree)
    assert torch.equal(top, tsk.stream_forward(
        senc, tsk.stage_basic(senc, p), [])[0])


def test_markov_on_cuda_matches_the_cpu(cuda_device):  # noqa: F811
    """``ops/markov.py`` on the card against the port on the CPU, within
    1e-12 (transient and dense stationary absolute, the blocked and LU
    solves relative to the largest entry)."""
    from canopy_tpu_torch.ops import markov
    from canopy_tpu_torch.utils.markov_models import (birth_death_csr,
                                                      random_lower_csr,
                                                      repairable_components)
    cpu = torch.device("cpu")
    Q = repairable_components(8, seed=1)
    p0 = np.random.default_rng(2).random((16, 256))
    p0 /= p0.sum(axis=1, keepdims=True)
    got = markov.markov_transient(Q, p0, 30.0, device=cuda_device)
    assert got.device.type == "cuda"
    want = markov.markov_transient(Q, p0, 30.0, device=cpu)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    sp = birth_death_csr(600, seed=3)
    for method in ("dense", "sparse"):
        q = sp.toarray()
        got = markov.markov_stationary(torch.from_numpy(q).to(cuda_device),
                                       method=method)
        want = markov.markov_stationary(torch.from_numpy(q), method=method)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-12)
    indptr, indices, data, diag = random_lower_csr(2000, 3e-3, seed=0,
                                                   chain=True)
    b = np.random.default_rng(3).uniform(-1, 1, (3, 2000))
    got, want = [markov.compile_blocked_triangular(
        indptr, indices, data, diag, device=d).solve(
            torch.from_numpy(b).to(d)).cpu().numpy()
        for d in (cuda_device, cpu)]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_compiled_model_round_trip_on_cuda(cuda_device, tmp_path):  # noqa: F811,E501
    """A saved and loaded slice tree through ``make_propagator`` on the
    card gives tops bit-equal to the tree before saving, on samples of
    the loaded tape under the same key."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.io.compiled_io import load_compiled, save_compiled
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    path = tmp_path / "slice.npz"
    save_compiled(path, tree, tape)
    loaded, loaded_tape = load_compiled(path)
    key = fold_in(prng_key(7), 0)
    samples = loaded_tape.sample(key, 65_536, 8760.0, cuda_device)
    assert torch.equal(samples, tape.sample(key, 65_536, 8760.0,
                                            cuda_device))
    basic = torch.clamp(samples, 0.0, 1.0).float()
    before = make_propagator(tree, cuda_device)(basic)
    after = make_propagator(loaded, cuda_device)(basic)
    assert torch.equal(after, before)


def test_sharded_stream_step_on_one_nccl_rank(cuda_device,  # noqa: F811
                                              tmp_path):
    """``parallel.sharded_stream_step`` on a one-rank NCCL group launches
    the stream kernel and equals ``stream_propagate`` to the bit."""
    import torch.distributed as dist
    from canopy_tpu_torch.parallel.distributed import initialize
    from canopy_tpu_torch.parallel.mesh import make_mesh
    from canopy_tpu_torch.parallel.quantify import (gather_trials,
                                                    shard_trials,
                                                    sharded_stream_step)
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_ccf")
    enc = tsk.encode_stream(tsk.compile_stream(tree))
    house = tree.house_state_vector()
    gen = torch.Generator(device="cuda").manual_seed(11)
    basic = torch.rand((65_536, tree.n_basic), generator=gen,
                       device="cuda") * 0.05
    initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cuda",
               timeout=60)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh("cuda")
        step = sharded_stream_step(enc, mesh, house)
        start = counters()
        tops = gather_trials(mesh, step(shard_trials(mesh, basic)))
        torch.cuda.synchronize()
        assert launches_since(start)["stream"] > 0
    finally:
        dist.destroy_process_group()
    assert torch.equal(tops, tsk.stream_propagate(enc, basic, house))


def _plain_tape_sample(monkeypatch, tape, key, n, device):
    """``tape.sample`` with both kernels' plain versions, on ``device``."""
    import canopy_tpu_torch.compiler.expr_tape as et
    with monkeypatch.context() as m:
        m.setattr(et, "draw_standard",
                  lambda table, out: prng.draw_standard_plain(table, out)
                  or out)
        m.setattr(et, "draw_gamma", prng.draw_gamma_plain)
        return tape.sample(key, n, 8760.0, device)


def test_prng_kernels_bit_equal_to_plain(cuda_device,  # noqa: F811
                                         monkeypatch):
    """Both threefry kernels against their plain versions on the card, on
    the every-kind tape (one ``draw_standard`` launch, one ``draw_gamma``
    per gamma or beta deviate) and on the slice tape."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.mef import expr
    from canopy_tpu_torch.mef.parameter import MissionTime
    from canopy_tpu_torch.utils.scale_models import every_deviate_kind
    key = prng_key(20261017)
    tape = ExpressionTape.build(every_deviate_kind(expr, MissionTime()))
    start = counters()
    got = tape.sample(key, 65_536, 8760.0, cuda_device)
    torch.cuda.synchronize()
    n_gamma = sum(1 for op in tape._ops
                  if op[0] in ("gamma-deviate", "beta-deviate"))
    assert launches_since(start)["prng"] == 1 + n_gamma == 6
    want = _plain_tape_sample(monkeypatch, tape, key, 65_536, cuda_device)
    assert torch.equal(got, want)
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    got = tape.sample(key, 1 << 16, 8760.0, cuda_device)
    assert torch.equal(got, _plain_tape_sample(monkeypatch, tape, key,
                                               1 << 16, cuda_device))
    table = prng.StandardTable()
    for kind in (prng.UNIFORM, prng.UNIFORM32, prng.NORMAL, prng.GUMBEL):
        table.add(fold_in(key, kind), kind, kind, stride=3, offset=kind % 3)
    out = torch.zeros((100_003, 4), dtype=torch.float64, device=cuda_device)
    plain = torch.zeros_like(out)
    prng.draw_standard(table, out)
    prng.draw_standard_plain(table, plain)
    assert torch.equal(out, plain)
    # Shapes from 1e-4 (boosts with exponents up to 10^4) to 10.
    alpha = torch.tensor(10.0 ** np.random.default_rng(13).uniform(
        -4.0, 1.0, (2, 50_000)), device=cuda_device)
    for log_space in (False, True):
        keys = prng.split(key, 2)
        assert torch.equal(
            prng.draw_gamma(keys, alpha, 50_000, log_space),
            prng.draw_gamma_plain(keys, alpha, 50_000, log_space))


def test_uncertainty_request_counts_its_copies(cuda_device):  # noqa: F811
    """One slice request through the modular chain on the card: the
    mission time up and back, the draw table's two tensors, the tape's
    host values (if any), the staged columns and house states of each
    streamed module, each module's output slot, and the statistics'
    summary back (the tops stay on the card); no build, one draw and one
    stream launch per streamed module (the second request, after the
    first cached the programs' tables), and one reduction on the card."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    modular = build_modular_bdd(tree, house_states=tree.house_state_vector())
    evaluator = make_modular_evaluator(modular, cuda_device)
    streamed = sum(bdd.resolved_root() > 1 for bdd, _slot in modular.chain)
    n = 1 << 14

    def request():
        uncertainty_analysis(tree, tape, 11, n, 8760.0, cuda_device,
                             top_fn=evaluator)
    request()
    before = counters()
    request()
    after = counters()
    delta = {k: after[k] - before[k] for k in after}
    needed = 1 if tape._sample_plan(torch.tensor(8760.0,
                                                 dtype=torch.float64)
                                    )["needed"] else 0
    assert delta["trials"] == n
    assert delta["builds"] == 0
    # The mission time (8 B), then 20 quantiles' and the 95th
    # percentile's neighbours, the middle pair, 21 edges, the trials below
    # 19 inner edges, mean and std, as float64: the same at every n.
    assert delta["d2h"] == 2
    assert delta["d2h_bytes"] == 8 + 8 * (2 * 21 + 2 + 21 + 19 + 2)
    assert delta["stats_on_device"] == 1
    assert delta["h2d"] == 3 + needed + 2 * streamed + len(modular.chain)
    assert delta["launch.prng"] == 1
    assert delta["launch.stream"] == streamed


def test_sequence_statistics_on_the_card(cuda_device,  # noqa: F811
                                         monkeypatch):
    """The plant event tree's requests at 2^14 and 2^16 trials on the
    card: every sequence's statistics against NumPy on the same float64
    trials (``assert_sequence_stats``: the interval and error factor to
    the bit, the moments within 1e-13), one reduction on the card a
    request, no build, and the same copies off the card and bytes at
    both sizes (a summary of fixed size comes back)."""
    from canopy_tpu_torch.engine import sequences
    settings = Settings()
    model = Initializer(fixture_inputs("torch_event_tree_plant"),
                        settings).model
    (initiating,) = model.initiating_events
    compiled = sequences.compile_event_tree(model, initiating, settings,
                                            cuda_device)
    trials = {}
    products = sequences._sequence_trials

    def capture(*args):
        trials.clear()
        trials.update(products(*args))
        return trials
    monkeypatch.setattr(sequences, "_sequence_trials", capture)
    readbacks = []
    for n in (1 << 14, 1 << 16):
        sequences.sequence_uncertainty(compiled, n, n)
        before = counters()
        out = sequences.sequence_uncertainty(compiled, n + 1, n)
        after = counters()
        delta = {k: after[k] - before[k] for k in after}
        assert delta["stats_on_device"] == 1
        assert delta["builds"] == 0
        assert delta["sequences"] == len(out) == 64
        readbacks.append((delta["d2h"], delta["d2h_bytes"]))
        rows = torch.stack([trials[k] for k in range(64)])
        assert rows.dtype == torch.float64 and rows.is_cuda
        rows = rows.cpu().numpy()
        for k in range(64):
            assert_sequence_stats(out[k], rows[k])
    assert readbacks[0] == readbacks[1]


@pytest.fixture(scope="module")
def plant_event_tree():
    """The plant event tree compiled on the card (its forest gives up, so
    its roots form one multi-root stream program)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from canopy_tpu_torch.engine import sequences
    settings = Settings()
    model = Initializer(fixture_inputs("torch_event_tree_plant"),
                        settings).model
    (initiating,) = model.initiating_events
    return sequences.compile_event_tree(model, initiating, settings,
                                        torch.device("cuda"))


@pytest.mark.parametrize("n", [1 << 14, (1 << 16) + 3])
def test_roots_kernel_matches_plain(plant_event_tree, n):
    """The multi-root kernel on the plant tree's 64 roots: float64, one
    launch, bit-equal to its plain version on the card (the second size
    leaves the last block ragged), within 1e-12 absolute of the gather
    engine (its count gates round their DP in another order)."""
    from canopy_tpu_torch.engine.propagate import propagate_probability
    c = plant_event_tree
    (group,) = c.root_groups
    gen = torch.Generator(device="cuda").manual_seed(n)
    basic = 0.3 * torch.rand((n, c.tree.n_basic), dtype=torch.float64,
                             device="cuda", generator=gen)
    staged = basic[:, group.cols].T.contiguous()
    start = counters()
    got = tsk.stream_roots_forward(group.program, staged, group.house)
    assert launches_since(start) == {"stream_roots": 1}
    assert got.dtype == torch.float64 and got.shape == (64, n)
    assert torch.equal(got, tsk.stream_roots_forward_plain(
        group.program, staged, group.house))
    want = propagate_probability(c.tree, basic, c.house[0])[
        :, c.root_index].T
    assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
def test_served_request_launches_the_roots_kernel_once(plant_event_tree,
                                                       n):
    """A served plant request on the card: one multi-root launch and no
    single-top stream launch, no build, every gated sequence by direct
    propagation; its copies are the sampler's and the statistics' alone
    (the program's tables, columns and house vector went up at
    compile)."""
    import zlib

    from canopy_tpu_torch.engine import sequences
    c = plant_event_tree
    sequences.sequence_uncertainty(c, n, n)
    before = counters()
    out = sequences.sequence_uncertainty(c, n + 1, n)
    after = counters()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["launch.stream_roots"] == 1
    assert delta["launch.stream"] == 0 and delta["builds"] == 0
    assert {row["method"] for row in out.values()} == {"direct-propagation"}
    key = fold_in(prng_key(n + 1), zlib.crc32(b"IE") & 0x7FFFFFFF)
    start = counters()
    samples = c.uncertainty_tape().sample(key, n, c.mission, c.device)
    sequences.sequence_statistics(samples[:, :64].T.contiguous())
    end = counters()
    for k in ("h2d", "d2h"):
        assert delta[k] == end[k] - start[k]


def _numpy_statistics(tops: np.ndarray) -> dict:
    """NumPy's statistics of ``tops`` on the host, with 20 quantiles and
    20 bins: what ``summarize`` is held to."""
    median = float(np.median(tops))
    density, edges = np.histogram(tops, bins=20, density=True)
    return {"quantiles": np.quantile(tops, np.linspace(0.0, 1.0, 20)),
            "error_factor": float(np.quantile(tops, 0.95)) / median,
            "edges": edges, "density": density, "mean": float(tops.mean()),
            "std": float(tops.std(ddof=1))}


@pytest.mark.parametrize("n", [1 << 20, 1 << 14, 3 * (1 << 12) + 7])
def test_statistics_on_the_card_match_numpy(cuda_device, n):  # noqa: F811
    """The slice's float32 tops reduced on the card against NumPy on the
    same tops: quantiles, error factor, edges and density to the bit;
    mean and std (float64 sums on the card, float32 in NumPy) within 1e-6
    relative."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.uncertainty import (
        sample_basic_probabilities, summarize)
    _m, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                         tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    modular = build_modular_bdd(tree, house_states=tree.house_state_vector())
    evaluator = make_modular_evaluator(modular, cuda_device)
    with torch.no_grad():
        tops = evaluator(sample_basic_probabilities(
            tape, prng_key(n), n, 8760.0, cuda_device))
    assert tops.dtype == torch.float32
    got = summarize(tops)
    want = _numpy_statistics(tops.cpu().numpy())
    assert np.array_equal(got.quantiles, want["quantiles"])
    assert got.error_factor == want["error_factor"]
    assert got.histogram_edges.dtype == np.float32
    assert np.array_equal(got.histogram_edges, want["edges"])
    assert np.array_equal(got.histogram_density, want["density"])
    for k in ("mean", "std"):
        assert abs(getattr(got, k) - want[k]) <= 1e-6 * want[k], k


def test_statistics_on_the_card_edge_cases(cuda_device):  # noqa: F811
    """All-equal tops (NumPy's range widened by 0.5 each way), two
    trials, and random float32 arrays of many sizes and spans, whose
    float32 edges a float64 linspace would miss: the card's results equal
    NumPy's to the bit."""
    from canopy_tpu_torch.engine.uncertainty import summarize
    rng = np.random.default_rng(16)
    arrays = [np.full(1000, 0.25, np.float32),
              np.array([3e-4, 1e-4], np.float32)]
    arrays += [(rng.random(int(rng.integers(2, 5000))) * 10.0
                ** rng.uniform(-9, 0)).astype(np.float32)
               for _ in range(300)]
    for x in arrays:
        got = summarize(torch.from_numpy(x).to(cuda_device))
        want = _numpy_statistics(x)
        assert np.array_equal(got.quantiles, want["quantiles"])
        assert got.error_factor == want["error_factor"]
        assert np.array_equal(got.histogram_edges, want["edges"])
        assert np.array_equal(got.histogram_density, want["density"])
        np.testing.assert_allclose([got.mean, got.std],
                                   [x.astype(np.float64).mean(),
                                    x.astype(np.float64).std(ddof=1)],
                                   rtol=1e-12)
