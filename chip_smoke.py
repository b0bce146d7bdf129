"""Smoke run of the torch port on one CUDA card: kernels, then the slice.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (it exits
non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is missing).  Phases, each raising on failure:

1. the device: ``nvidia-smi`` name and power limit;
2. the kernel build (``nvcc`` for ``sm_90a`` from ``canopy_tpu_torch/csrc``,
   and beside it the Philox rate probe ``tools/philox_rate.cu``), and the
   SASS per packed word of the Philox kernel and of the probe's loop,
   counted by instruction kind (``cuobjdump -sass``, where the toolkit
   has it);
3. every kernel against its plain PyTorch version on the card: the
   forward bit-equal at 1,048,576 trials on the slice's big BDD module (in
   its batched schedule), on the slice tree's uncapped stream program
   (the direct-propagation path's importance program) and on the
   prod/pair/count tree programs of two fixtures (the step kernel on
   the module, also in its depth-first order; the one-trial-per-thread
   kernel on the trees); the level-parallel logged forward and backward,
   f32 and f64, bit-equal at 1, 1,024 and 4,096 trials, and the backward
   within ``GRAD_RTOL`` of torch autograd through the f64 plain forward;
   CUDA-event times of kernel and plain, the level kernels beside a
   critical-path model (levels x ``SMEM_ROUND_TRIP`` cycles); each
   kernel instantiation's ptxas registers, stack and spills;
4. the fused whole-tree kernel (``csrc/fused.cu``: the ring body on the
   tree's live-row program, rows in device memory) against its plain
   version, bit-equal at 1,048,576 and 100,003 trials: as the tiled
   counterpart on the slice tree and on ``demo_plant`` (a house event),
   as the lane-row one on ``aralia_like_large`` and
   ``aralia_like_nested_count`` (count gates up to 33 DP states); each
   plan logged (block width, ring depth, live rows, blocks per SM,
   shared bytes); CUDA-event times of kernel and plain, and of the
   stream kernel on the same inputs (all but ``demo_plant``);
5. dispatch: ``make_propagator(engine="auto")`` picks the uncapped tree
   stream on the slice tree, on ``aralia_like_large`` and on the
   9,363-gate hierarchical tree of ``bench.py``'s importance section
   (16,384 trials), and ``engine="fused"`` the tiled kernel on the slice
   tree and the lane-row one on ``aralia_like_large``; each agrees with
   the f64 gather engine within ``TOP_RTOL`` (per trial, except on the
   hierarchical tree, whose tops near 1e-5 float32 cannot resolve to 1e-5
   relative: there normwise and bit-equal to the float32 gather); then
   an ``atleast 2`` gate over 130 basic events at p = 0.01 through
   ``make_propagator(engine="auto")`` (the stream kernel), uncertainty
   and stream importance, within 1e-6 of the CPU f64 values and of the
   JAX package's value; the path ``wide-count``: ``cardinality [130,
   140]`` over 300 basic events (142 DP states: the device-memory DP
   scratch) at ``WIDE_TRIALS`` trials through the stream, both fused,
   the replay and the spill kernels, each bit-equal to its plain version
   and within ``TOP_RTOL`` of the CPU f64 gather engine, and at one f64
   trial through both adjoints (logged forward and level backward, taped
   forward and level backward), bit-equal to plain, their gradients
   within 1e-5 of the CPU f64 importance;
6. the BDD slice, through the CLI in-process
   (``tests/fixtures/torch_slice_plant.xml --device cuda --bdd
   --importance --uncertainty --num-trials 1048576 --seed 7``): its
   kernels launched, the stream method tag, probability / MIF / cut-set
   count against ``tests/fixtures/torch_slice_golden.json``, and the
   kernel's per-trial tops of 65,536 sampled trials against the f64 level
   evaluation of the same samples (the run's samples redrawn under
   ``prng_key(seed)``, its one ``draw_standard`` launch counted);
6'. the threefry kernels (``csrc/prng.cu``, phase ``prng``): random bits
   and uniforms equal to the ``jax.random`` draws frozen in
   ``tests/fixtures/torch_prng_golden.json`` (2^20 elements, fixed
   indices), normals, Gumbel noise, gammas and betas within
   ``PRNG_DRAW_RTOL``; the slice tape at 2^20 trials in one
   ``draw_standard`` launch, bit-equal to the plain version and within
   ``PRNG_DRAW_RTOL`` of the frozen JAX samples at fixed (trial, column)
   pairs, kernel and plain timed on the tape's table beside the bound
   (the block written, ``THREEFRY_INT_OPS`` per draw on the ALU lanes,
   the float64 work); the every-kind tape
   (``utils/scale_models.every_deviate_kind``) at ``PRNG_KIND_TRIALS``
   trials, one launch plus one per gamma or beta deviate, bit-equal to
   plain; the path ``prng``: the slice through the CLI in-process with
   the golden file's flags (``--bdd --uncertainty --num-trials 16384
   --batch-size 8192 --seed 7``), its uncertainty block within
   ``PRNG_UNC_RTOL`` of the JAX CLI's;
7. the direct-propagation slice, through ``RiskAnalysis`` with
   ``algorithm("pdag").approximation("none")``, importance and 1,048,576
   uncertainty trials: ``stream``, ``stream_log`` and ``adjoint``
   launched, probability / MIF / cut-set count against
   ``tests/fixtures/torch_pdag_golden.json``, the redrawn batch
   reproducing the reported mean exactly, and 65,536 of its trials'
   kernel tops against the f64 gather engine;
8. the replay path (``csrc/replay.cu`` and ``csrc/replay_adjoint.cu``,
   the ring kernel of ``csrc/replay_ops.cuh``; the backward
   ``csrc/adjoint.cu`` on the program's level form): (a) ``bench.py``'s
   65,536-gate replay tree at 65,536 trials through
   ``make_propagator(engine="replay")`` and the staged pair, bit-equal to
   the plain version and to the stream kernel on the same inputs, 2,048
   trials within ``TOP_RTOL`` of the f64 gather engine, the plan's block
   width and ring depth and the kernel's ptxas row logged; (b) the
   16,384-gate replay-adjoint tree under a forced small schedule (every
   kind of read: pool, resident, basic stream, slab, refill, gate
   stream), forward, taped forward and backward bit-equal to plain; (c)
   ``make_differentiable_replay`` on that tree at 1,024 float32 trials
   (``bench.py``'s size), taped forward and backward bit-equal to plain
   and the gradient within ``GRAD_RTOL`` of autograd through the f64
   plain forward, the backward beside its critical-path model (levels x
   ``SMEM_ROUND_TRIP`` cycles); (c') both again at one f64 trial,
   importance's shape; (d) ``_make_replay_importance_fn`` (f64, one
   trial), timed end to end, its MIF within ``REPLAY_MIF_RTOL`` of the
   stream adjoint's.  Inputs come from numpy (seed ``REPLAY_SEED``), so
   the CPU can reproduce any trial.  CUDA-event times of replay, stream
   and plain;
9. Monte Carlo and the spill engine (``csrc/bernoulli.cu``,
   ``csrc/spill.cu``): (a) the Philox kernel bit-equal to its plain
   version on the slice's 263 events x 312,500 words (10^7 trials) and
   on the plant tree's 65,536 events x one 32,768-word chunk, then the
   rate probe's words, operations and SASS instructions per clock and SM
   (the kernel's integer work alone, no loads or division); the path
   ``mc``: (b) the slice through the CLI in-process with
   ``--monte-carlo --num-trials 10000000`` (the estimate within 6 sigma +
   1e-4 of the slice's exact probability, its standard error the
   formula's), (c) ``RiskAnalysis`` Monte Carlo at each golden anchor's
   ``mc_trials`` (within ``mc_4sigma`` of its exact probability), (d)
   ``plant_hier_9363`` through ``packed_top_probability`` at 10,002,432
   trials, chunked (within its ``mc_4sigma``); the path ``spill``: (e)
   ``make_propagator(engine="spill")`` (the ring kernel of
   ``csrc/replay_ops.cuh``) on the 65k replay tree at 65,536 trials,
   bit-equal to plain, to the stream kernel and to the replay kernel,
   2,048 trials within ``TOP_RTOL`` of the f64 gather engine, its ring
   plan logged (block width, depth, pool, pads) and timed beside replay
   and the stream; (f) a forced small schedule on the 16k tree with every
   spill op kind through the ring, bit-equal to plain;
10. the locality-reordered big tree (``csrc/block_gather.cu``,
   ``csrc/gather.cu``): ``plant_hier_9363``'s tree through
   ``random_shuffle(seed=1)`` and ``locality_reorder(hot_first=True)``
   (the shuffled tree alone is refused by ``engine="block"``), 65,536
   trials of uniform(1e-4, 5e-3) float32 drawn on the card; the path
   ``block``: ``make_propagator(engine="block")`` (the log kernel, within
   ``BLOCK_LOG_RTOL`` of its plain version, ``BLOCK_AGREE`` trials within
   ``TOP_RTOL`` of the f64 gather engine) and ``block_gather_propagate(
   mode="direct")`` (bit-equal to plain and to the float32 gather engine);
   then ``bsr_top_probability`` on the shuffled tree reordered with
   ``method="auto"`` (within ``BSR_RTOL`` of the float32 gather engine)
   and, for context, the stream kernel on the same inputs; the path
   ``gather``: ``gather_propagate`` on that tree and on a ragged product
   tree, each bit-equal to plain and to the float32 gather engine.

11. event trees, alignment phases and SIL (``RiskAnalysis.run()``
   through the CLI in-process, ``--device cuda``): (a) ``hand_event_tree``,
   ``demo_plant``, ``station_blackout`` and ``aralia_like_alignment``
   (default Settings, ``--probability``), every sequence and fault-tree
   or phase probability within ``PROB_RTOL`` of the JAX values frozen in
   ``tests/fixtures/torch_event_tree_golden.json``, and the slice plant
   under ``--sil --time-step 100`` (PFD/PFH averages, SIL level, band
   fractions, the 88-point curve); the path ``et``: (b) the 64-sequence
   scale model (``utils/scale_models.event_tree_scale_xml(deviates=True)``)
   with ``--uncertainty`` at ``ET_TRIALS`` trials on the BDD forest path:
   the stream kernel launched once per sequence root, every sequence's
   method ``bdd-stream-f32``, root 0's kernel tops on the redrawn samples
   bit-equal to the stream's plain version and averaging to the reported
   mean, every root's tops within ``TOP_RTOL`` of the f64 level
   evaluation; (c) the plant-width event tree
   (``tests/fixtures/torch_event_tree_plant.xml``, loaded after the slice
   plant: six systems over it, 64 sequences) with ``--uncertainty`` at
   ``ET_TRIALS`` trials: its forest exceeds 2,000,000 nodes, so it runs
   direct propagation, one ``stream_roots`` launch for its one house row
   and no ``stream`` launch beyond the fault trees' modules; its sequence
   probabilities stay within ``PROB_RTOL`` of the golden values.  Host
   times from the reports' timings (walk, compile, forest or
   propagation, sampling, per-sequence evaluation); device times of
   sampling and the per-sequence kernels by CUDA events, redone on the
   same inputs (the roots kernel's in 11');
11'. the path ``roots``: the plant event tree's 64 sequence roots as one
   multi-root stream program (``compile_tree_stream`` with ``roots``) at
   ``ET_TRIALS`` float64 trials of its tape's samples: one
   ``stream_roots`` launch, bit-equal to the plain version and within
   ``ROOTS_ATOL`` of the gather engine; CUDA-event times of the kernel,
   the staging, the plain version and the gather engine beside the
   kernel's bound (the staged rows read and the roots written once, or
   its operations);
12. the path ``project``, on the slice at ``PROJECT_TRIALS`` trials: (a)
   a project file (``bdd``, probability, importance, uncertainty, a fixed
   seed) through ``python -m canopy_tpu_torch --project`` in its own
   process (the default device, cuda), its report's fault-tree results
   and settings equal to the flag-driven CLI's in-process; (b)
   ``--version``, git-derived where the tree is a git checkout; (c)
   ``save_compiled`` / ``load_compiled`` of the slice tree and its tape:
   the loaded tape's samples under ``fold_in(prng_key(seed), 0)`` equal the
   tape's, and the
   loaded tree's stream tops through ``make_propagator`` bit-equal to the
   tree's before saving; (d) ``model_to_mef_xml`` of the slice, parsed
   again through the CLI: probability within ``PROB_RTOL``, the same
   products; (e) a ``CheckpointedSweep`` of ``SWEEP_BATCHES`` x
   ``SWEEP_TRIALS`` trials (each batch samples the tape under ``(seed,
   batch)`` and runs the stream kernel), stopped by an exception at batch
   ``SWEEP_STOP`` and resumed from its checkpoint: its final state equal
   to the uninterrupted sweep's, bit for bit; the flag-driven run of (a)
   takes ``--validate`` (the slice against the bundled MEF grammar), and
   its XML report validates against the report grammar;
13. the path ``markov`` (f64, torch operations): ``markov_stationary`` of
   ``tests/test_markov.py``'s 10,000-state CSR birth-death chain (host
   LU, the blocked substitutions on the card; its test's checks), the
   dense path on its first 2,000 states against numpy's solve on the
   host, ``markov_transient`` of 12 repairable components (4,096 states)
   over 1,024 initial distributions against scipy's ``expm_multiply``,
   and ``BlockedTriangular.solve`` of ``tests/test_markov.py``'s
   10,000-row lower chain system against ``spsolve_triangular``.  Every
   device call of phases 12-13 is timed by CUDA events beside its
   ``RooflineAccountant`` bytes share and peak memory, and each phase
   prints its wall time;
14. the path ``parallel`` (``canopy_tpu_torch/parallel/``): (a) one NCCL
   rank on the card: ``dryrun_multichip``, then every entry point at full
   width (``parallel_steps``): the stream step on the slice's BDD module
   at ``PARALLEL_STREAM_TRIALS``, the grad step on it at
   ``PARALLEL_GRAD_TRIALS`` f32 trials (within ``GRAD_RTOL`` of the f64
   grad step), the replay step on the 65k tree, partition and pipeline
   on the reordered ``plant_hier_9363`` tree in slabs, the cut-set
   quantifier on the slice's minimal cut sets (f64, within
   ``PROB_RTOL``); every sharded top bit-equal to the unsharded path on
   the same trials; (b) ``PARALLEL_RANKS`` spawned ranks sharing the card
   over gloo (``PARALLEL_RANK_TRIALS`` trials per rank on the stream
   step; gate rows and levels split over both ranks), each running
   ``dryrun_multichip`` and the same steps, importing no JAX.  Logged:
   CUDA-event ms per rank and step beside the unsharded path's, the bytes
   each collective moved, the collectives copied through host memory,
   the launches and the phase's wall time.

Each path (5's two, 6, 6''s ``prng``, 7, 8, 9's two, 10's two, 11's
``et``, 11''s ``roots``, 12's ``project`` and 14's ``parallel``) runs with the
launch counts set to 0 just before it and read just after; a kernel of the
path that never launched fails the run.  Long output goes to ``chiprun_out/``.  The last lines are the
kernels' JSON record (with each kernel's bound: the larger of its bytes
over the card's memory rate and its operations over its peak rate), the
card's ``nvidia-smi`` line, and the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SLICE_MODEL = os.path.join(FIXTURES, "torch_slice_plant.xml")
SLICE_GOLDEN = os.path.join(FIXTURES, "torch_slice_golden.json")
PDAG_GOLDEN = os.path.join(FIXTURES, "torch_pdag_golden.json")
#: The plant-width event tree: the slice plant, then what the event tree
#: adds to it.
ET_PLANT = [SLICE_MODEL,
            os.path.join(FIXTURES, "torch_event_tree_plant.xml")]
ET_GOLDEN = os.path.join(FIXTURES, "torch_event_tree_golden.json")
PHILOX_PROBE_SRC = os.path.join(ROOT, "tools", "philox_rate.cu")
PHILOX_PROBE_LIB = os.path.join(OUT_DIR, "philox_rate.so")
#: The event-tree path's trials and seed (phase 11).
ET_TRIALS = 1 << 20
ET_SEED = 7
SLICE_TRIALS = 1 << 20
RAGGED_TRIALS = 100_003
SLICE_SEED = 7
AGREE_TRIALS = 65_536
#: Trials of the hierarchical tree's stream dispatch (bench.py's size),
#: and how many of them the f64 gather engine re-evaluates.
HIER_TRIALS = 16_384
HIER_AGREE = 2_048

#: Backward kernel against autograd through the f64 plain forward, as the
#: per-trial normwise relative error (largest error over largest
#: gradient).  f32 partials of a Shannon mux lose digits where hi and lo
#: nearly cancel, so single entries can be far off in relative terms; the
#: f64 kernels (importance's path) carry no such loss.
GRAD_RTOL = {"f32": 1e-4, "f64": 1e-12}
#: Phase 8: ``bench.py``'s replay tree and its replay-adjoint tree (the
#: same generator at 16,384 gates), the trial counts, the seed of the
#: numpy inputs (uniform(0, 0.05), as ``bench.py`` draws them), and the
#: forced small schedule under which every kind of read occurs.
REPLAY_TREE = dict(n_basic=8192, n_gates=65536, fanin=4, n_levels=14,
                   seed=0)
ADJOINT_TREE = dict(REPLAY_TREE, n_gates=16384)
REPLAY_RUN_TRIALS = 65_536
REPLAY_AGREE = 2_048
ADJOINT_TRIALS = 1_024
REPLAY_SEED = 20263
SMALL_SCHEDULE = dict(pool_slots=256, resident_tiles=128)
#: MIF of the replay adjoint against the stream adjoint, both f64 over
#: the same gate arithmetic (only the order of some sums differs),
#: relative to the largest MIF and per event above 1e-6 of it.
REPLAY_MIF_RTOL = 1e-12
#: Probability against the frozen f64 JAX value (same f64 level order).
PROB_RTOL = 1e-12
#: MIF of the (f64) adjoint kernel against the frozen f64 JAX MIF, for
#: every event above 1e-6 of the largest MIF.
MIF_RTOL = 1e-4
#: The same on the direct-propagation path: the tree's f64 adjoint
#: against the JAX package's f64 gather autodiff (same gate arithmetic).
PDAG_MIF_RTOL = 1e-10
#: Per-trial f32 kernel tops against the f64 level evaluation.
TOP_RTOL = 1e-5

#: Phase 9: the Monte Carlo seed, the Bernoulli shapes (words of 32
#: trials: the slice's 10^7 trials, one chunk of the plant tree), the
#: slice CLI's trial count, the plant anchor's trial count, and the forced
#: small spill schedule on the 16k tree (a pool near the widest gate's
#: working set, a staging ring of 256-row chunks, short segments).
MC_SEED = 7
MC_SLICE_TRIALS = 10_000_000
BERN_SLICE_WORDS = 312_500
BERN_PLANT_WORDS = 32_768
SPILL_SMALL = dict(pool_slots=16, chunk_tiles=256, slab_tiles=8,
                   max_ops_per_segment=2048, hoist_events=16)

#: Phase 10: the plant tree's trials, their seed (drawn on the card), how
#: many the f64 gather engine re-evaluates, the trial slab of the plain
#: versions, the float32 gather engine and BSR, and BSR's ``t_chunk``.
BLOCK_TRIALS = 65_536
BLOCK_SEED = 20265
BLOCK_AGREE = 2_048
BLOCK_SLAB = 8_192
BSR_T_CHUNK = 2_048
#: The log kernel against its plain version, per trial: the card's
#: ``logf``/``expf`` against torch's (bit-equal where they agree).
BLOCK_LOG_RTOL = 1e-6
#: BSR (a float32 log-space product) against the float32 gather engine,
#: per trial.
BSR_RTOL = 1e-5
#: The JAX package's ``make_propagator`` value of atleast 2 of 130 basic
#: events at p = 0.01 (float32, its TPU-path precision).
WIDE_ATLEAST_JAX = 0.37371027
#: Trials and input seed of the residual count window's engines.
WIDE_TRIALS = 4_096
WIDE_SEED = 20267
#: The ragged product tree (padded fan-in positions, ``arg_mask`` False).
RAGGED_TREE = dict(n_basic=32, n_gates=40, fanin=4, seed=3)

#: One H100 SXM at its full 700 W (NVIDIA's data sheet): HBM3 rate, and
#: peak rates outside the tensor cores by value size (float32, float64).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}
#: SMs of the card and its integer rates per SM and clock (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0): 64 results of 32-bit integer multiply on the FMA
#: pipe, so 32 wide 32 x 32 -> 64-bit products (two results each); 64
#: logical operations and compares on the ALU pipe, which issues beside
#: it; 128 thread-instructions issued (four schedulers).  The pipe probe
#: of ``tools/philox_rate.cu`` measures them (phase 9a).  At the SM clock
#: nvidia-smi reports, for the Philox kernel's integer work.
N_SMS = 132
WIDE_PRODUCTS_PER_CLOCK = 32
ALU_LANES = 64
ISSUE_LANES = 128
#: Special-function units of the card (132 SMs x 16 per clock), for the
#: block-gather log kernel's logs and exps.
SFU_LANES = 132 * 16
#: Cycles of one dependent shared-memory round trip (load, use, store),
#: for the level-parallel kernels' critical-path model.
SMEM_ROUND_TRIP = 30
#: Integer operations of one packed word, by pipe.  8 Philox calls x 10
#: rounds x 2 wide products, less the 28 that repeat across a word's
#: eight calls (their first rounds' counter words are equal: 14 in round
#: 0, 7 in each of rounds 1 and 2), is 132 on the FMA pipe (the built
#: kernel's SASS has 132 ``IMAD.WIDE.U32``).  8 x 10 x 2 three-input
#: XORs, less the 14 that repeat, and 32 compares, 178 on the ALU pipe.
#: The key schedule and the bit packing are left out.  The pipes overlap,
#: so the larger share bounds a word: the products, 132 at 32 per clock.
BERN_PRODUCTS_PER_WORD = 8 * 10 * 2 - 28
BERN_ALU_OPS_PER_WORD = 8 * 10 * 2 - 14 + 32
#: SM clocks per packed word and SM.
BERN_CLOCKS_PER_WORD = max(
    BERN_PRODUCTS_PER_WORD / WIDE_PRODUCTS_PER_CLOCK,
    BERN_ALU_OPS_PER_WORD / ALU_LANES,
    (BERN_PRODUCTS_PER_WORD + BERN_ALU_OPS_PER_WORD) / ISSUE_LANES)
#: The probe's launch: blocks x threads, each making PHILOX_PROBE_REPS
#: words (about 1.4e8 words); the pipe probe's, each thread making
#: PIPE_PROBE_REPS loop trips of 32 steps of each kind it runs.
PHILOX_PROBE_SHAPE = (132 * 64, 256)
PHILOX_PROBE_REPS = 64
PIPE_PROBE_SHAPE = (132 * 16, 256)
PIPE_PROBE_REPS = 128

#: Phase ``prng``: the frozen JAX draws and uncertainty block, the
#: every-kind tape's trials, the draws' tolerance against JAX's (float64
#: transcendental functions rounding otherwise than XLA's in the last
#: bits) and the CLI's against JAX's block (float32 stream tops against
#: the JAX package's float64 BDD evaluation, as ``TOP_RTOL``).
PRNG_GOLDEN = os.path.join(FIXTURES, "torch_prng_golden.json")
PRNG_KIND_TRIALS = 65_536
PRNG_DRAW_RTOL = 1e-12
PRNG_UNC_RTOL = 1e-5
#: Integer operations of one threefry2x32 call, counted from
#: ``csrc/prng.cu``: two key additions, 20 rounds of an add, a rotate
#: (one funnel shift) and a XOR, five injections of two adds.  Each is one
#: instruction on the ALU pipe (``ALU_LANES`` per SM and clock).
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2
#: float64 operations a draw adds by row kind and transform, counted from
#: the source (the normal: scale and shift, ``x * -x``, ``w - 3.125``, 22
#: Horner steps of a multiply and an add, ``p * x``, ``* sqrt(2)``; the
#: library's ``log1p``, ``log`` and ``exp`` counted as one each).
PRNG_KIND_F64_OPS = {0: 1, 1: 1, 2: 2 + 1 + 1 + 1 + 44 + 1 + 1, 3: 5}
PRNG_TRANSFORM_F64_OPS = {0: 0, 1: 2, 2: 3}

KERNELS = {
    "stream": ("canopy_tpu_torch/csrc/stream.cu",
               "canopy_tpu/ops/stream_kernel.py:135"),
    "stream_log": ("canopy_tpu_torch/csrc/stream.cu",
                   "canopy_tpu/ops/adjoint_kernel.py:40"),
    "adjoint": ("canopy_tpu_torch/csrc/adjoint.cu",
                "canopy_tpu/ops/adjoint_kernel.py:164"),
    "fused_tiled": ("canopy_tpu_torch/csrc/fused.cu",
                    "canopy_tpu/ops/pallas_kernels.py:258"),
    "fused": ("canopy_tpu_torch/csrc/fused.cu",
              "canopy_tpu/ops/pallas_kernels.py:175"),
    "replay": ("canopy_tpu_torch/csrc/replay.cu",
               "canopy_tpu/ops/stream_kernel.py:381"),
    "replay_tape": ("canopy_tpu_torch/csrc/replay_adjoint.cu",
                    "canopy_tpu/ops/replay_adjoint_kernel.py:32"),
    "replay_bwd": ("canopy_tpu_torch/csrc/adjoint.cu",
                   "canopy_tpu/ops/replay_adjoint_kernel.py:138"),
    "bernoulli": ("canopy_tpu_torch/csrc/bernoulli.cu",
                  "canopy_tpu/ops/pallas_kernels.py:45"),
    "spill": ("canopy_tpu_torch/csrc/spill.cu",
              "canopy_tpu/ops/stream_kernel.py:221"),
    "gather": ("canopy_tpu_torch/csrc/gather.cu",
               "canopy_tpu/ops/gather_kernel.py:40"),
    "block_log": ("canopy_tpu_torch/csrc/block_gather.cu",
                  "canopy_tpu/ops/block_gather.py:269"),
    "block_direct": ("canopy_tpu_torch/csrc/block_gather.cu",
                     "canopy_tpu/ops/block_gather.py:331"),
    "prng": ("canopy_tpu_torch/csrc/prng.cu",
             "jax.random (no Pallas kernel)"),
    "stream_roots": ("canopy_tpu_torch/csrc/stream.cu",
                     "XLA's gather engine (no Pallas kernel; "
                     "canopy_tpu/engine/analysis.py:835-842)"),
}
#: The path whose launch count each kernel's record reports.
PATH_OF = {"stream": "bdd-slice", "stream_log": "bdd-slice",
           "adjoint": "bdd-slice", "fused_tiled": "dispatch",
           "fused": "dispatch", "replay": "replay", "replay_tape": "replay",
           "replay_bwd": "replay", "bernoulli": "mc", "spill": "spill",
           "gather": "gather", "block_log": "block", "block_direct": "block",
           "prng": "prng", "stream_roots": "et-plant"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_tree(name: str):
    from canopy_tpu_torch.compiler.graph import compile_fault_tree
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    model = Initializer([os.path.join(FIXTURES, f"{name}.xml")],
                        Settings().ccf_analysis(True)).model
    tree_name = {"torch_slice_plant": "slice",
                 "demo_plant": "Cooling"}.get(name, name)
    return compile_fault_tree(model.fault_trees.get(tree_name))


def op_flops(enc, backward: bool = False) -> int:
    """Arithmetic operations of one trial of an encoded program, counted
    from its op table: complements, products, sums and the count DP (the
    backward: each partial, its product with the adjoint and its
    accumulation)."""
    from canopy_tpu_torch.ops.stream_kernel import COUNT, MUX, PAIR, PROD
    flags = enc.args[:, 2]
    total = 0
    for kind, _out, b, e, aux0, aux1, _row in enc.ops.tolist():
        n_args = e - b
        total += int(flags[b:e].sum())
        if kind == MUX:
            total += 8 if backward else 4
        elif kind == PROD:
            total += (4 * n_args - 1 if backward else n_args - 1) + aux0
        elif kind == PAIR:
            total += (8 if backward else 4) + aux0
        elif kind == COUNT:
            cap = aux1 + 1
            dp = n_args * (3 * cap + 1) + max(aux1 - aux0, 0)
            total += n_args * (dp + 3) if backward else dp
    return total


def bound(n_bytes: float, flops: float, itemsize: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[itemsize] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


#: The counters at the last :func:`reset_counts`.
_COUNTS_AT: dict = {}


def launches_since(start: dict) -> dict:
    """Each kernel's launches since the ``counters()`` snapshot
    ``start``."""
    from canopy_tpu_torch.utils.profiling import counters
    return {key[len("launch."):]: n - start.get(key, 0)
            for key, n in counters().items() if key.startswith("launch.")}


def reset_counts() -> None:
    from canopy_tpu_torch.utils.profiling import counters
    torch.cuda.synchronize()
    _COUNTS_AT.update(counters())


def read_counts(record: dict, path: str, kernels) -> dict:
    """The launch counts of ``path`` since the last :func:`reset_counts`;
    fails unless each of its kernels launched."""
    torch.cuda.synchronize()
    launches = launches_since(_COUNTS_AT)
    record.setdefault("paths", {})[path] = launches
    for name in kernels:
        check(launches[name] > 0, f"{path}: kernel {name} never launched")
    return launches


def ptxas_table(report: str) -> dict:
    """nvcc's ``-Xptxas -v`` report as {kernel: {registers, stack,
    spill_stores, spill_loads, shared}} (``shared``: static bytes; the
    level kernels' shared-memory logs are dynamic, sized per launch).  An
    instantiation a later source compiles again (``spill.cu`` runs
    ``replay.cu``'s ring kernel) is keyed ``name@source``."""
    table: dict = {}
    name = source = None
    first: dict = {}
    for line in report.splitlines():
        m = re.match(r"nvcc: (\S+)", line)
        if m:
            source = m.group(1)
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            if first.setdefault(name, source) != source:
                name = f"{name}@{source}"
            table[name] = {"registers": None, "stack": 0, "spill_stores": 0,
                           "spill_loads": 0, "shared": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            table[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            table[name]["shared"] = int(m.group(1)) if m else 0
    return table


def short_name(mangled: str) -> str:
    """``stream_level_forward_kernel<f32,1>`` from an instantiation's
    mangled name (value type, then the integer and bool template
    arguments in order; ``@source`` kept), or the base name of a kernel
    that is no template."""
    mangled, _at, source = mangled.partition("@")
    suffix = f"@{source}" if source else ""
    for base in PTXAS_KERNELS:
        at = mangled.find(base + "I")
        if at >= 0:
            args = mangled[at + len(base) + 1:]
            vtype = {"f": "f32", "d": "f64"}[args[0]]
            rest = re.findall(r"L[ib](\d+)E", args.split("EEv")[0])
            return f"{base}<{','.join([vtype, *rest])}>{suffix}"
        if base + "E" in mangled:
            return base + suffix
    return mangled + suffix


#: The redesigned kernels' base names, as the ptxas report's mangled
#: names hold them.
PTXAS_KERNELS = ("stream_steps_kernel", "stream_ops_kernel",
                 "stream_level_forward_kernel",
                 "stream_level_backward_kernel", "replay_forward_kernel",
                 "fused_forward_kernel")


def phase_build(record: dict) -> None:
    from canopy_tpu_torch.ops._build import (NVCC_FLAGS, build_info,
                                             load_library)
    t0 = time.perf_counter()
    # The Philox rate probe builds beside the package, in parallel.
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    probe_cmd = [nvcc if os.path.exists(nvcc) else "nvcc", *NVCC_FLAGS,
                 "-shared", "-o", PHILOX_PROBE_LIB, PHILOX_PROBE_SRC]
    probe = subprocess.Popen(probe_cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    lib = load_library()
    info = build_info()
    _out, err = probe.communicate(timeout=600)
    check(probe.returncode == 0, f"{' '.join(probe_cmd)} failed:\n{err}")
    log(f"[build] {time.perf_counter() - t0:.3f} s (nvcc "
        f"{info['seconds']:.3f} s, built={info['built']}): {info['path']}")
    for line in info.get("cmd", "").splitlines():
        log(f"[build] {line}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] ptxas {line.strip()}")
    # The redesigned kernels' instantiations: registers, stack, spills.
    table = {short_name(k): v for k, v in
             ptxas_table(info.get("ptxas", "")).items()
             if any(n in k for n in PTXAS_KERNELS)}
    for name, row in table.items():
        log(f"[build] {name}: {json.dumps(row)}")
    record["ptxas"] = table
    # The Philox kernel's SASS per packed word, and the probe's per word
    # of its loop, by kind.
    sass = {"kernel": kernel_sass(info["path"], "packed_bernoulli_kernel"),
            "probe": kernel_sass(PHILOX_PROBE_LIB, "philox_rate_kernel")}
    for mode in range(3):
        sass[f"pipe{mode}"] = kernel_sass(PHILOX_PROBE_LIB,
                                          f"pipe_rate_kernelILi{mode}E")
        if sass[f"pipe{mode}"] is not None:
            log(f"[build] pipe probe mode {mode} SASS per loop trip: "
                f"{json.dumps(sass[f'pipe{mode}']['ops'])}")
    for name in ("kernel", "probe"):
        counts = sass[name]
        if counts is None:
            log(f"[build] Philox {name} SASS: no cuobjdump here")
            continue
        log(f"[build] Philox {name} SASS per packed word: "
            f"{counts['per_word_total']} instructions "
            f"{json.dumps(counts['per_word'])}; the bound counts "
            f"{BERN_PRODUCTS_PER_WORD} wide products and "
            f"{BERN_ALU_OPS_PER_WORD} ALU-pipe operations per word, "
            f"{BERN_CLOCKS_PER_WORD} SM clocks per word and SM")
        log(f"[build] Philox {name} SASS opcodes per word: "
            f"{json.dumps(counts['ops'])}")
    record["bernoulli_sass"] = sass
    from canopy_tpu_torch.ops.stream_kernel import (MAX_COUNT_STATES,
                                                    REC_CHUNK)
    check(lib.canopy_max_count_states() == MAX_COUNT_STATES,
          "kernel and wrapper disagree on the count-DP bound")
    check(lib.canopy_stream_rec_chunk() == REC_CHUNK,
          "kernel and wrapper disagree on the record chunk")
    from canopy_tpu_torch.ops.fused_kernel import SMEM_BYTES
    smem = lib.canopy_fused_max_smem_bytes()
    log(f"[build] opt-in shared memory per block: {smem} B (the fused "
        f"kernels assume {SMEM_BYTES})")
    check(smem >= SMEM_BYTES, "less shared memory than the fused kernels "
                              "assume")


def kernel_sass(lib_path: str, kernel: str) -> dict | None:
    """Instructions of ``kernel`` in a built library by kind
    (``cuobjdump -sass``), or None where the toolkit has no
    ``cuobjdump``.  Per packed word: a kernel with a loop (the probe)
    counts the loop, from the target of its last backward branch to that
    branch; one without (``packed_bernoulli_kernel``, unrolled, one word
    per thread) counts its body up to its last ``EXIT``, leaving out
    what follows (the 64-bit division's slow path)."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    code: list[tuple[int, str, int | None]] = []  # (address, op, target)
    inside = False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if inside and m:
            t = re.match(r"\s+0x([0-9a-f]+)", m.group(3))
            code.append((int(m.group(1), 16), m.group(2),
                         int(t.group(1), 16) if t and
                         m.group(2).startswith("BRA") else None))
    if not code:
        return None
    exits = [i for i, (_a, op, _t) in enumerate(code) if op == "EXIT"]
    rets = [i for i, (_a, op, _t) in enumerate(code) if op.startswith("RET")]
    end = max([i for i in exits if not rets or i < rets[0]] or
              [len(code) - 1]) + 1
    back = [(t, a) for a, _op, t in code[:end] if t is not None and t < a]
    if back:
        lo, hi = back[-1]
        ops = [op for a, op, _t in code if lo <= a <= hi]
    else:
        ops = [op for _a, op, _t in code[:end]]

    def kind(op: str) -> str:
        for prefix, name in (("IMAD.WIDE", "IMAD.WIDE"),
                             ("IMAD.HI", "IMAD.HI"), ("LOP3", "LOP3"),
                             ("ISETP", "ISETP"), ("IADD3", "IADD3"),
                             ("IMAD", "IMAD (other)"), ("I2F", "division"),
                             ("F2I", "division"), ("MUFU", "division"),
                             ("CALL", "division"), ("NOP", "NOP")):
            if op.startswith(prefix):
                return name
        return "other"
    per_word: dict = {}
    for op in ops:
        per_word[kind(op)] = per_word.get(kind(op), 0) + 1
    return {"per_word": dict(sorted(per_word.items())),
            "per_word_total": len(ops), "loop": bool(back),
            "total": len(code),
            "ops": dict(sorted({op: ops.count(op)
                                for op in set(ops)}.items()))}


def module_bdd(label: str):
    """The slice's BDD module that ``programs()`` labels ``label``."""
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    for bdd, _slot in build_modular_bdd(load_tree("torch_slice_plant")).chain:
        if label == f"slice-module-{bdd.n_nodes}":
            return bdd
    raise KeyError(label)


def programs():
    """(label, encoded program, house) of every program phase 3 checks:
    the slice's big BDD module (the BDD slice's stream program), the slice
    tree's uncapped stream program (the direct-propagation slice's
    importance program), and two fixtures' shared-scheduler programs."""
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    from canopy_tpu_torch.ops.stream_kernel import (bdd_stream_encoding,
                                                    compile_stream,
                                                    encode_stream,
                                                    tree_stream_encoding)
    out = []
    slice_tree = load_tree("torch_slice_plant")
    for bdd, _slot in build_modular_bdd(slice_tree).chain:
        if bdd.n_nodes >= 256:
            out.append((f"slice-module-{bdd.n_nodes}",
                        bdd_stream_encoding(bdd), []))
    out.append(("slice-tree", tree_stream_encoding(slice_tree),
                slice_tree.house_state_vector()))
    for name in ("aralia_like_ccf", "aralia_like_noncoherent"):
        tree = load_tree(name)
        out.append((f"{name}-tree", encode_stream(compile_stream(tree)),
                    tree.house_state_vector()))
    return out


def _grad_error(grad: torch.Tensor, g64: torch.Tensor) -> float:
    """Per trial, the largest gradient error over the largest gradient
    (normwise relative error), maximized over trials."""
    g64 = g64.double()
    err = (grad.double() - g64).abs().amax(dim=0)
    return float((err / g64.abs().amax(dim=0).clamp(min=1e-300)).max())


def level_model_ms(n_levels: int, clock_hz: float) -> float:
    """A model, not a bound: the level-parallel kernels' critical path as
    ``n_levels`` dependent shared-memory round trips of
    ``SMEM_ROUND_TRIP`` cycles each at ``clock_hz``."""
    return n_levels * SMEM_ROUND_TRIP / clock_hz * 1e3


def phase_kernels(device, record: dict) -> None:
    from canopy_tpu_torch.ops.adjoint_kernel import (stream_backward,
                                                     stream_backward_plain)
    from canopy_tpu_torch.ops.stream_kernel import (compile_bdd_stream,
                                                    encode_stream,
                                                    house_tensor,
                                                    level_schedule,
                                                    stream_forward,
                                                    stream_forward_plain,
                                                    stream_variant)
    progs = programs()
    kinds = set()
    for label, enc, house in progs:
        kinds |= {int(k) for k in enc.ops[:, 0]}
    check({0, 1, 2, 3} <= kinds, "programs must cover prod/pair/count/mux")
    gen = torch.Generator(device=device)
    gen.manual_seed(20260)
    clock = sm_clock_hz()

    def probabilities(shape, dtype=torch.float32):
        # PRA-scale inputs, as bench.py's bdd-stream section draws them.
        return (torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float64) * 0.02).to(dtype)

    for label, enc, house in progs:
        # The stream record is the BDD slice's program at its uncertainty
        # shape; the logged forward's and the adjoint's the same module at
        # importance's shape (one f64 trial), where the BDD slice runs
        # them (PATH_OF).  The slice tree's numbers are further timings.
        main = label.startswith("slice-module")
        importance = label == "slice-tree"
        h32 = house_tensor(enc, house, device)
        # Forward at the uncertainty batch size, f32 as uncertainty runs.
        staged = probabilities((enc.n_basic, SLICE_TRIALS))
        variant = stream_variant(enc)
        top, _ = stream_forward(enc, staged, house)
        plain, _ = stream_forward_plain(enc, staged, h32)
        torch.cuda.synchronize()
        err = float((top - plain).abs().max())
        check(err == 0.0, f"{label}: forward differs from plain ({err})")
        ms = cuda_ms(lambda: stream_forward(enc, staged, house), 5)
        plain_ms = cuda_ms(lambda: stream_forward_plain(enc, staged, h32),
                           1)
        log(f"[kernels] {label}: {enc.n_ops} ops, pool {enc.pool_slots}, "
            f"f32 forward at {SLICE_TRIALS} trials bit-equal to plain; "
            f"kernel {ms:.3f} ms ({variant}), plain {plain_ms:.3f} ms")
        sweep = [{"variant": variant, "ms": ms}]
        if main:
            record["stream"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, variant=variant,
                shape=f"{enc.n_ops} ops x {SLICE_TRIALS} trials, f32",
                **bound((enc.n_basic + 1) * SLICE_TRIALS * 4,
                        op_flops(enc) * SLICE_TRIALS, 4))
            # The same module in depth-first order (no independent steps):
            # what the batched schedule buys.
            dfs = encode_stream(compile_bdd_stream(module_bdd(label)))
            row_of = {int(c): r for r, c in enumerate(enc.staged_cols)}
            dstaged = staged[torch.tensor(
                [row_of[int(c)] for c in dfs.staged_cols], device=device)]
            got, _ = stream_forward(dfs, dstaged, house)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"{label}: depth-first order "
                                           f"differs from plain")
            p_ms = cuda_ms(lambda: stream_forward(dfs, dstaged, house), 3)
            sweep.append({"variant": stream_variant(dfs), "ms": p_ms,
                          "order": "depth-first"})
            log(f"[kernels] {label} in depth-first order (pool "
                f"{dfs.pool_slots}): stream bit-equal to plain, "
                f"{p_ms:.3f} ms")
            del dstaged
        record.setdefault("stream_sweep", {})[label] = sweep
        del staged, top, plain
        torch.cuda.empty_cache()
        # Logged forward and backward, in both value types, at 1 trial
        # (importance's shape, f64 on the main path), 1,024 and 4,096
        # trials, bit-equal to plain.
        sched = level_schedule(enc)
        model = level_model_ms(sched.n_levels, clock)
        for n in (1, 1024, 4096):
            for dtype in (torch.float64, torch.float32):
                name = "f64" if dtype == torch.float64 else "f32"
                staged = probabilities((enc.n_basic, n), dtype)
                ct = (torch.rand(n, generator=gen, device=device,
                                 dtype=torch.float64) + 0.5).to(dtype)
                hd = h32.to(dtype)
                ptop, plog = stream_forward_plain(enc, staged, hd, True)
                pgrad = stream_backward_plain(enc, staged, hd, plog, ct)
                top, vlog = stream_forward(enc, staged, house,
                                           with_log=True)
                grad = stream_backward(enc, staged, house, vlog, ct)
                torch.cuda.synchronize()
                log_err = float((vlog - plog).abs().max())
                grad_err = float((grad - pgrad).abs().max())
                check(torch.equal(top, ptop) and log_err == 0.0,
                      f"{label}: {name} logged forward differs at {n}")
                check(grad_err == 0.0, f"{label}: {name} backward differs "
                                       f"from plain at {n} trials "
                                       f"({grad_err})")
                ms_log = cuda_ms(lambda: stream_forward(
                    enc, staged, house, with_log=True), 5)
                ms_bwd = cuda_ms(lambda: stream_backward(
                    enc, staged, house, plog, ct), 5)
                # Autograd through the f64 plain forward.
                s64 = staged.double().requires_grad_(True)
                t64, _ = stream_forward_plain(enc, s64, h32.double())
                (g64,) = torch.autograd.grad(t64, s64, ct.double())
                rel = _grad_error(grad, g64)
                limit = GRAD_RTOL[name]
                check(rel <= limit, f"{label}: {name} backward vs f64 "
                                    f"autograd {rel:.3e} > {limit}")
                pms_log = cuda_ms(lambda: stream_forward_plain(
                    enc, staged, hd, True), 1)
                pms_bwd = cuda_ms(lambda: stream_backward_plain(
                    enc, staged, hd, plog, ct), 1)
                log(f"[kernels] {label}: {name} logged forward + backward "
                    f"at {n} trials bit-equal to plain; backward vs f64 "
                    f"autograd {rel:.3e} (limit {limit}); log {ms_log:.4f} "
                    f"ms / adjoint {ms_bwd:.4f} ms ({sched.n_levels} "
                    f"levels, critical path {model:.4f} ms: a model); "
                    f"plain {pms_log:.3f} / {pms_bwd:.3f} ms")
                if main and n == 1 and name == "f64":
                    record["stream_log"].update(
                        max_abs_err=log_err, ms=ms_log, plain_ms=pms_log,
                        shape=f"{enc.n_ops} ops x 1 trial, f64",
                        critical_path_model_ms=model,
                        **bound((enc.n_basic + 1 + enc.n_log) * 8,
                                op_flops(enc), 8))
                    record["adjoint"].update(
                        max_abs_err=grad_err, ms=ms_bwd, plain_ms=pms_bwd,
                        shape=f"{enc.n_ops} ops x 1 trial, f64",
                        critical_path_model_ms=model,
                        **bound((2 * enc.n_basic + enc.n_log + 1) * 8,
                                op_flops(enc, backward=True), 8))
                if main or importance:
                    record.setdefault("timings", {})[
                        f"{label} {name}@{n}"] = {
                        "log_ms": ms_log, "log_plain_ms": pms_log,
                        "adjoint_ms": ms_bwd, "adjoint_plain_ms": pms_bwd,
                        "n_levels": sched.n_levels,
                        "critical_path_model_ms": model}


def phase_slice(device, record: dict) -> None:
    from canopy_tpu_torch.ops.prng import prng_key
    from canopy_tpu_torch.cli import main as cli_main
    from canopy_tpu_torch.compiler.modules import (build_modular_bdd,
                                                   modular_probability)
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.bdd_eval import make_modular_evaluator
    from canopy_tpu_torch.engine.uncertainty import \
        sample_basic_probabilities

    with open(SLICE_GOLDEN) as fh:
        golden = json.load(fh)
    report_path = os.path.join(OUT_DIR, "torch_slice_report.json")
    argv = [SLICE_MODEL, "--device", "cuda", "--bdd", "--importance",
            "--uncertainty", "--num-trials", str(SLICE_TRIALS), "--seed",
            str(SLICE_SEED), "-o", report_path]
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(record, "bdd-slice",
                           ("stream", "stream_log", "adjoint", "prng"))
    check(rc == 0, f"CLI exited {rc}")
    log(f"[slice] python -m canopy_tpu_torch {' '.join(argv)}: "
        f"{seconds:.3f} s, launches {launches}")
    with open(report_path) as fh:
        report = json.load(fh)
    (ft,) = report["fault_trees"]
    log(f"[slice] timings {json.dumps(report['timings'])}")
    unc = ft["uncertainty"]
    check(unc["method"] == "bdd-stream-f32",
          f"uncertainty method {unc['method']}")
    p_err = abs(ft["probability"] - golden["exact_probability"]) \
        / golden["exact_probability"]
    check(p_err <= PROB_RTOL, f"probability rel err {p_err:.3e}")
    check(ft["n_products"] == golden["n_products"],
          f"{ft['n_products']} cut sets, golden {golden['n_products']}")
    gold_imp = golden["importance"]
    mif_max = max(v["MIF"] for v in gold_imp.values())
    worst = 0.0
    n_checked = 0
    for row in ft["importance"]:
        want = gold_imp[row["event"]]["MIF"]
        if want > 1e-6 * mif_max:
            worst = max(worst, abs(row["MIF"] - want) / want)
            n_checked += 1
    check(worst <= MIF_RTOL, f"MIF rel err {worst:.3e}")
    log(f"[slice] P = {ft['probability']!r} (rel err {p_err:.3e}, limit "
        f"{PROB_RTOL}); {ft['n_products']} cut sets; MIF of {n_checked} "
        f"events within {worst:.3e} (limit {MIF_RTOL}); uncertainty mean "
        f"{unc['mean']!r}, method {unc['method']}")

    # Per-trial agreement: redraw the run's one batch (an unbatched run
    # draws under prng_key(seed)), check that the kernel reproduces the
    # reported mean, then hold 65,536 of its trials against the f64 level
    # evaluation.
    from canopy_tpu_torch.settings import Settings
    tree = load_tree("torch_slice_plant")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    modular = build_modular_bdd(tree)
    samples = sample_basic_probabilities(tape, prng_key(SLICE_SEED),
                                         SLICE_TRIALS,
                                         Settings().mission_time(), device)
    ev = make_modular_evaluator(modular, device)
    with torch.no_grad():
        tops = ev(samples)
        mean = float(tops.cpu().numpy().mean())
        check(mean == unc["mean"], f"redrawn batch mean {mean!r} != "
                                   f"reported {unc['mean']!r}")
        ref = modular_probability(modular, samples[:AGREE_TRIALS])
    rel = float(((tops[:AGREE_TRIALS].double() - ref).abs()
                 / ref.abs()).max())
    check(rel <= TOP_RTOL, f"per-trial tops rel err {rel:.3e}")
    log(f"[slice] {AGREE_TRIALS} sampled trials: kernel tops vs f64 level "
        f"evaluation max rel err {rel:.3e} (limit {TOP_RTOL}); redrawn "
        f"batch reproduces the reported mean exactly")
    record["slice_seconds"] = seconds


def phase_fused(device, record: dict) -> None:
    """(a) The fused kernel against its plain version, bit-equal, through
    both entry points; each tree's plan logged, the stream kernel timed
    on the same inputs."""
    from canopy_tpu_torch.ops._build import load_library
    from canopy_tpu_torch.ops.fused_kernel import (encode_fused,
                                                   fused_forward,
                                                   fused_forward_plain,
                                                   fused_plan,
                                                   fused_supported,
                                                   fused_tiled_supported)
    from canopy_tpu_torch.ops.stream_kernel import (house_tensor,
                                                    stream_forward,
                                                    tree_stream_encoding)
    lib = load_library()
    gen = torch.Generator(device=device)
    gen.manual_seed(20261)
    cases = [("torch_slice_plant", "fused_tiled"),
             ("demo_plant", "fused_tiled"),
             ("aralia_like_large", "fused"),
             ("aralia_like_nested_count", "fused")]
    plans = record.setdefault("fused_plans", {})
    for name, kernel in cases:
        tree = load_tree(name)
        tiled = kernel == "fused_tiled"
        check(fused_tiled_supported(tree) == tiled and
              fused_supported(tree), f"{name}: not a {kernel} tree")
        enc = encode_fused(tree)
        live, plan = fused_plan(enc)
        plans[name] = {"block_trials": plan.width, "ring_depth": plan.depth,
                       "live_rows": live.pool_slots, "gates": enc.n_ops,
                       "blocks_per_sm": lib.canopy_fused_blocks_per_sm(
                           plan.shared_bytes),
                       "shared_bytes": plan.shared_bytes,
                       "chunk_words": plan.chunk_words}
        log(f"[fused] {name}: plan {json.dumps(plans[name])}")
        house = tree.house_state_vector()
        h32 = house_tensor(enc, house, device)
        for n in (SLICE_TRIALS, RAGGED_TRIALS):
            staged = (torch.rand((enc.n_basic, n), generator=gen,
                                 device=device, dtype=torch.float64)
                      * 0.02).to(torch.float32)
            top = fused_forward(enc, staged, house, tiled)
            plain = fused_forward_plain(enc, staged, h32)
            torch.cuda.synchronize()
            err = float((top - plain).abs().max())
            check(err == 0.0, f"{name}: {kernel} differs from plain at "
                              f"{n} trials ({err})")
            ms = cuda_ms(lambda: fused_forward(enc, staged, house, tiled),
                         5)
            plain_ms = cuda_ms(lambda: fused_forward_plain(enc, staged,
                                                           h32), 1)
            log(f"[fused] {name}: {kernel}, {tree.n_gates} gates on "
                f"{live.pool_slots} live rows, {enc.n_basic} basics, {n} "
                f"trials: bit-equal to plain; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms")
            if name != "demo_plant" and n == SLICE_TRIALS:
                # The stream kernel on the same tree and inputs (its
                # uncapped program, pool in device memory): every gate
                # runs the same arithmetic in either order.
                senc = tree_stream_encoding(tree)
                sstaged = staged[torch.from_numpy(senc.staged_cols)
                                 .to(device)]
                check(torch.equal(stream_forward(senc, sstaged, house)[0],
                                  top), f"{name}: stream and fused differ")
                stream_ms = cuda_ms(lambda: stream_forward(
                    senc, sstaged, house)[0], 5)
                log(f"[fused] {name}: the stream kernel on the same "
                    f"inputs ({senc.n_ops} ops, pool {senc.pool_slots}): "
                    f"{stream_ms:.3f} ms; fused {ms:.3f} ms")
                plans[name].update(ms=ms, stream_ms=stream_ms)
                del sstaged
            if name in ("torch_slice_plant", "aralia_like_large") and \
                    n == SLICE_TRIALS:
                record[f"{kernel}_vs_stream_ms"] = plans[name]["stream_ms"]
                record[kernel].update(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    shape=f"{name}, {tree.n_gates} gates x {n} trials, "
                          f"f32",
                    **bound((enc.n_basic + 1) * n * 4, op_flops(enc) * n,
                            4))
            del staged, top, plain
        torch.cuda.empty_cache()


def phase_dispatch(device, record: dict) -> None:
    """(b) ``make_propagator(engine="auto")`` on three trees and
    ``engine="fused"`` on two, each against the f64 gather engine."""
    from canopy_tpu_torch.engine.propagate import make_propagator
    from canopy_tpu_torch.ops.stream_kernel import (stage_basic,
                                                    stream_forward,
                                                    tree_stream_encoding)
    from canopy_tpu_torch.utils.synthetic import synthetic_hierarchical_tree
    t0 = time.perf_counter()
    hier = synthetic_hierarchical_tree(n_basic=65536, branching=8,
                                       share_fraction=0.1, n_shared=128,
                                       seed=0)
    check((hier.n_gates, hier.nnz) == (9363, 74904),
          f"hierarchical tree {hier.n_gates} gates, {hier.nnz} edges")
    enc = tree_stream_encoding(hier)
    log(f"[dispatch] hierarchical tree: {hier.n_gates} gates, {hier.nnz} "
        f"edges; its uncapped stream program {enc.n_ops} ops over "
        f"{enc.pool_slots} pool slots, {enc.n_basic} staged basics "
        f"(built and encoded in {time.perf_counter() - t0:.3f} s)")
    gen = torch.Generator(device=device)
    gen.manual_seed(20262)
    slice_tree = load_tree("torch_slice_plant")
    large = load_tree("aralia_like_large")
    cases = [("torch_slice_plant", slice_tree, "auto", "stream",
              AGREE_TRIALS, AGREE_TRIALS),
             ("aralia_like_large", large, "auto", "stream", AGREE_TRIALS,
              AGREE_TRIALS),
             ("hierarchical", hier, "auto", "stream", HIER_TRIALS,
              HIER_AGREE),
             ("torch_slice_plant", slice_tree, "fused", "fused_tiled",
              AGREE_TRIALS, AGREE_TRIALS),
             ("aralia_like_large", large, "fused", "fused", AGREE_TRIALS,
              AGREE_TRIALS)]
    reset_counts()
    for name, tree, request, engine, n, n_ref in cases:
        fn = make_propagator(tree, device, engine=request)
        check(fn.engine == engine, f"{name}: {request} picked {fn.engine}")
        p = torch.rand((n, tree.n_basic), generator=gen, device=device,
                       dtype=torch.float64) * 0.02
        gather = make_propagator(tree, device, engine="gather")
        with torch.no_grad():
            tops = fn(p)
            ref = gather(p[:n_ref])
            err = (tops[:n_ref].double() - ref).abs()
        rel = float((err / ref.abs()).max())
        if name == "hierarchical":
            # This tree's smallest tops (about 1e-5) are ORs computed as
            # 1 - prod(1 - p), whose float32 rounding is absolute: per
            # trial only float32's own error is attainable.  The kernel
            # runs the gather engine's products in its order, so it is
            # held to the float32 gather bit for bit, and to the f64 one
            # normwise (largest error over largest top).
            with torch.no_grad():
                same = torch.equal(tops[:n_ref], gather(p[:n_ref].float()))
            check(same, f"{name}: stream tops differ from the f32 gather")
            norm = float(err.max() / ref.abs().max())
            check(norm <= TOP_RTOL, f"{name}: stream tops vs f64 gather "
                                    f"normwise {norm:.3e}")
            what = (f"bit-equal to the f32 gather; vs f64 gather normwise "
                    f"{norm:.3e} (limit {TOP_RTOL}), per trial {rel:.3e}")
            hier_p = p
        else:
            check(rel <= TOP_RTOL,
                  f"{name}: {engine} tops vs gather {rel:.3e}")
            what = (f"vs f64 gather max rel err {rel:.3e} (limit "
                    f"{TOP_RTOL})")
        log(f"[dispatch] {name}: {request} -> {engine} at {n} trials; on "
            f"{n_ref} of them {what}")
        del p, tops, ref, err
    launches = read_counts(record, "dispatch",
                           ("fused_tiled", "fused", "stream"))
    # The stream kernel alone on the staged input (after the count).
    staged = stage_basic(enc, hier_p)
    del hier_p
    ms = cuda_ms(lambda: stream_forward(enc, staged, [])[0], 5)
    log(f"[dispatch] hierarchical: stream kernel {ms:.3f} ms at "
        f"{HIER_TRIALS} trials (staged input {enc.n_basic} x "
        f"{HIER_TRIALS} f32)")
    record["hier_stream_ms"] = ms
    del staged
    log(f"[dispatch] launches {launches}")
    torch.cuda.empty_cache()


def count_gate_tree(n: int, lo: int, hi: int | None):
    """One count gate over ``n`` basic events at p = 0.01: ``atleast lo``
    when ``hi`` is None, else ``cardinality [lo, hi]`` with every fifth
    argument complemented (``tests/test_torch_count_window.py``'s)."""
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
    if hi is None:
        top.formula = Formula(Connective.ATLEAST, [Arg(e) for e in events],
                              min_number=lo)
    else:
        top.formula = Formula(Connective.CARDINALITY,
                              [Arg(e, complement=i % 5 == 4)
                               for i, e in enumerate(events)],
                              min_number=lo, max_number=hi)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def phase_wide_count(device, record: dict) -> None:
    """Count windows on the card.  (a) atleast 2 of 130 basic events at
    p = 0.01 through ``make_propagator(engine="auto")`` (the stream
    kernel, its count DP absorbing at 2), uncertainty and stream
    importance, each within 1e-6 of the CPU f64 values.  (b) The path
    ``wide-count``: cardinality [130, 140] of 300 (142 DP states, beyond
    the kernels' local arrays: the device-memory DP scratch) at
    ``WIDE_TRIALS`` float32 trials of uniform(0.35, 0.55) through every
    engine whose kernel counts (stream, both fused kernels, replay,
    spill), each bit-equal to its plain version on the card and within
    ``TOP_RTOL`` of the CPU f64 gather engine per trial; then importance's
    shape (f64, one trial) through the stream adjoint and the replay
    adjoint, their kernels bit-equal to plain and their gradients within
    1e-5 of the CPU f64 importance MIF."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.importance import (
        importance_measures, make_stream_importance_fn)
    from canopy_tpu_torch.engine.propagate import make_propagator
    from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
    from canopy_tpu_torch.ops.adjoint_kernel import (stream_backward,
                                                     stream_backward_plain)
    from canopy_tpu_torch.ops.fused_kernel import (encode_fused,
                                                   fused_forward_plain,
                                                   fused_propagate,
                                                   tile_trials)
    from canopy_tpu_torch.ops.replay_adjoint_kernel import (
        replay_adjoint_backward, replay_backward_plain, replay_tape_forward)
    from canopy_tpu_torch.ops.stream_kernel import (
        MAX_COUNT_STATES, compile_replay_stream, compile_spill_stream,
        encode_replay, encode_spill, replay_forward_plain, replay_grad_basic,
        replay_propagate, spill_forward_plain, stage_basic, stage_replay,
        stream_forward, stream_forward_plain, tree_stream_encoding)
    tree = count_gate_tree(130, 2, None)
    p = torch.full((1, 130), 0.01, dtype=torch.float64)
    want = float(make_propagator(tree, "cpu")(p)[0])
    fn = make_propagator(tree, device)
    got = float(fn(p.to(device))[0])
    rel = abs(got - want) / want
    check(fn.engine == "stream" and rel <= 1e-6,
          f"wide atleast: {fn.engine} {got!r} vs CPU f64 {want!r}")
    jax_rel = abs(got - WIDE_ATLEAST_JAX) / WIDE_ATLEAST_JAX
    check(jax_rel <= 1e-6, f"wide atleast: {got!r} vs the JAX package's "
                           f"{WIDE_ATLEAST_JAX}")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    unc = uncertainty_analysis(tree, tape, SLICE_SEED, AGREE_TRIALS,
                               8760.0, device)
    check(abs(unc.mean - want) <= 1e-6 * want, f"wide atleast uncertainty "
                                              f"mean {unc.mean!r}")
    grads = []
    for dev in ("cpu", device):
        q = torch.full((130,), 0.01, dtype=torch.float64, device=dev,
                       requires_grad=True)
        make_stream_importance_fn(tree, None, dev)(q).backward()
        grads.append(q.grad.cpu())
    g_rel = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    check(g_rel <= 1e-6, f"wide atleast importance {g_rel:.3e}")
    log(f"[count] atleast 2 of 130 at p = 0.01 on the card: {got!r} "
        f"({fn.engine}, {getattr(fn, 'stream_variant', None)}; CPU f64 "
        f"{want!r}, rel {rel:.3e}; the JAX "
        f"package's {WIDE_ATLEAST_JAX}, rel {jax_rel:.3e}); uncertainty "
        f"mean over {AGREE_TRIALS} trials {unc.mean!r}; importance vs CPU "
        f"f64 {g_rel:.3e}")
    record["wide_atleast"] = {"value": got, "cpu_f64": want,
                              "rel": rel, "jax_rel": jax_rel,
                              "importance_rel": g_rel}

    # (b) The residual window, through every counting engine.
    t0 = time.perf_counter()
    tree = count_gate_tree(300, 130, 140)
    senc = tree_stream_encoding(tree)
    fenc = encode_fused(tree)
    renc = encode_replay(compile_replay_stream(tree, grs_chunk=512))
    spenc = encode_spill(compile_spill_stream(tree))
    states = {enc.max_count_states for enc in (senc, fenc, renc, spenc)}
    check(states == {142}, f"residual window forms {states}")
    p32 = np.random.default_rng(WIDE_SEED).uniform(
        0.35, 0.55, (WIDE_TRIALS, 300)).astype(np.float32)
    want = make_propagator(tree, "cpu", engine="gather")(
        torch.from_numpy(p32).double()).numpy()
    p = torch.from_numpy(p32).to(device)
    h = torch.zeros(1, device=device)
    log(f"[count] cardinality [130, 140] of 300: {states.pop()} DP states "
        f"(the kernels' local arrays hold {MAX_COUNT_STATES}); programs "
        f"and the CPU f64 reference in {time.perf_counter() - t0:.3f} s")
    runs = {
        "stream": (lambda: make_propagator(tree, device)(p),
                   lambda: stream_forward_plain(
                       senc, stage_basic(senc, p), h)[0]),
        "fused_tiled": (lambda: make_propagator(tree, device,
                                                engine="fused")(p),
                        lambda: fused_forward_plain(fenc, tile_trials(p),
                                                    h)),
        "fused": (lambda: fused_propagate(tree, p, []),
                  lambda: fused_forward_plain(fenc, tile_trials(p), h)),
        "replay": (lambda: replay_propagate(renc, p, []),
                   lambda: replay_forward_plain(
                       renc, stage_replay(renc, p), h)[0]),
        "spill": (lambda: make_propagator(tree, device, engine="spill")(p),
                  lambda: spill_forward_plain(
                      spenc, stage_basic(spenc, p), h))}
    reset_counts()
    result = {}
    for name, (run, plain) in runs.items():
        with torch.no_grad():
            tops, ref = run(), plain()
        check(torch.equal(tops, ref), f"residual window: {name} differs "
                                      f"from its plain version")
        rel = float((np.abs(tops.double().cpu().numpy() - want)
                     / np.abs(want)).max())
        check(rel <= TOP_RTOL, f"residual window: {name} vs CPU f64 "
                               f"{rel:.3e}")
        result[name] = rel
    # Importance's shape, one f64 trial: the stream adjoint (logged
    # forward, level backward) and the replay adjoint (taped forward,
    # level backward; its program has no resident tier) held to their
    # plain versions, and their gradients (the MIF) to the CPU f64
    # stream importance.  The replay adjoint builder's own guards (the
    # TPU's tape windows and count unroll) refuse this gate, so the
    # replay program is the forward's.
    point = torch.from_numpy(p32[0].astype(np.float64))
    want = importance_measures(tree, point, top_fn=make_stream_importance_fn(
        tree, None, "cpu")).mif
    got = importance_measures(tree, point.to(device),
                              top_fn=make_stream_importance_fn(
                                  tree, None, device)).mif
    one = torch.ones(1, dtype=torch.float64, device=device)
    h64 = h.double()
    staged = stage_basic(senc, point[None].to(device), torch.float64)
    top, vlog = stream_forward(senc, staged, [], with_log=True)
    ptop, plog = stream_forward_plain(senc, staged, h64, True)
    check(torch.equal(top, ptop) and torch.equal(vlog, plog) and
          torch.equal(stream_backward(senc, staged, [], vlog, one),
                      stream_backward_plain(senc, staged, h64, plog, one)),
          "residual window: stream importance kernels differ from plain")
    staged = stage_replay(renc, point[None].to(device), torch.float64)
    top, vlog = replay_tape_forward(renc, staged, [])
    ptop, plog = replay_forward_plain(renc, staged, h64, True)
    g_brs = replay_adjoint_backward(renc, staged, [], vlog, one)
    check(torch.equal(top, ptop) and torch.equal(vlog, plog) and
          torch.equal(g_brs, replay_backward_plain(renc, staged, h64, plog,
                                                   one)),
          "residual window: replay importance kernels differ from plain")
    g_replay = replay_grad_basic(renc, g_brs)[0].cpu().numpy()
    big = float(np.abs(want).max())
    for label, mif in (("stream", got), ("replay", g_replay)):
        rel = float(np.abs(mif - want).max()) / big
        check(rel <= 1e-5, f"residual window: {label} importance MIF vs "
                           f"CPU f64 {rel:.3e}")
        result[f"{label}_importance_mif"] = rel
    launches = read_counts(record, "wide-count", (
        "stream", "stream_log", "adjoint", "fused_tiled", "fused", "replay",
        "replay_tape", "replay_bwd", "spill"))
    log(f"[count] cardinality [130, 140] of 300 at {WIDE_TRIALS} trials: "
        f"every engine bit-equal to its plain version; per-trial max rel "
        f"err vs CPU f64 gather (limit {TOP_RTOL}) and importance MIF vs "
        f"CPU f64 (limit 1e-5): {json.dumps(result)}; launches {launches}")
    record["residual_window"] = result
    torch.cuda.empty_cache()


class plain_draws:
    """Within the block, the expression tape draws through the plain
    versions of ``csrc/prng.cu`` (on the tensors' device); ``tables``
    collects the ``draw_standard`` tables the tape builds, with or without
    the block."""

    tables: list = []

    def __init__(self, plain: bool = True):
        self.plain = plain

    def __enter__(self):
        import canopy_tpu_torch.compiler.expr_tape as et
        from canopy_tpu_torch.ops import prng
        self.saved = (et.draw_standard, et.draw_gamma)
        tables = plain_draws.tables = []

        def standard(table, out):
            tables.append(table)
            if self.plain:
                prng.draw_standard_plain(table, out)
                return out
            return prng.draw_standard(table, out)
        et.draw_standard = standard
        if self.plain:
            et.draw_gamma = prng.draw_gamma_plain
        return self

    def __exit__(self, *exc):
        import canopy_tpu_torch.compiler.expr_tape as et
        et.draw_standard, et.draw_gamma = self.saved
        return False


def prng_bound(table, n_trials: int, clock_hz: float) -> dict:
    """``draw_standard``'s bound on one table: the block written over the
    memory rate, against its integer work (``THREEFRY_INT_OPS`` per draw)
    over the ALU lanes at the SM clock and its float64 work over the
    float64 peak."""
    n_rows = len(table.rows)
    n = n_rows * n_trials
    t_bytes = (n * 8 + n_rows * 72) / HBM_BYTES_PER_S * 1e3
    t_int = n * THREEFRY_INT_OPS / (ALU_LANES * N_SMS * clock_hz) * 1e3
    f64_ops = n_trials * sum(PRNG_KIND_F64_OPS[r[2]] +
                             PRNG_TRANSFORM_F64_OPS[r[3]]
                             for r in table.rows)
    t_f64 = f64_ops / PEAK_FLOPS[8] * 1e3
    t_ops = max(t_int, t_f64)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "int_ms": t_int, "f64_ms": t_f64,
            "bytes_ms": t_bytes}


def _unc_errors(got: dict, want: dict) -> dict:
    """The largest relative error of each statistic of an uncertainty
    block (densities left out: a top within ``PRNG_UNC_RTOL`` of JAX's may
    fall into the next bin)."""
    out = {}
    for key in ("mean", "std", "error_factor"):
        out[key] = _rel(got[key], want[key])
    for key in ("ci95", "quantiles", "histogram_edges"):
        check(len(got[key]) == len(want[key]), f"{key}: lengths differ")
        out[key] = max(_rel(a, b) for a, b in zip(got[key], want[key]))
    return out


def phase_prng(device, record: dict) -> None:
    """(6') The threefry kernels (``csrc/prng.cu``): bit-equal to their
    plain versions on the slice tape at 2^20 trials and on the every-kind
    tape, within ``PRNG_DRAW_RTOL`` of the frozen ``jax.random`` draws;
    the path ``prng``: the slice's uncertainty through the CLI against the
    JAX package's block."""
    from canopy_tpu_torch.cli import main as cli_main
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.mef import expr
    from canopy_tpu_torch.mef.parameter import MissionTime
    from canopy_tpu_torch.ops import prng
    from canopy_tpu_torch.settings import Settings
    from canopy_tpu_torch.utils.profiling import counters
    from canopy_tpu_torch.utils.scale_models import every_deviate_kind

    with open(PRNG_GOLDEN) as fh:
        golden = json.load(fh)
    clock = sm_clock_hz()
    mission = Settings().mission_time()

    # (a) The frozen jax.random draws at fixed indices: bits (the plain
    # hash on the card) and uniforms exactly, the rest within the tolerance.
    d = golden["draws"]
    idx = torch.tensor(d["indices"], device=device)
    key = tuple(d["key"])
    bits32 = prng.random_bits(key, 32, (d["n"],), device)[idx]
    check(bits32.tolist() == d["bits32"], "threefry 32-bit bits")
    bits64 = prng.random_bits(key, 64, (d["n"],), device)[idx]
    check([b & (2**64 - 1) for b in bits64.tolist()] == d["bits64"],
          "threefry 64-bit bits")
    draws = {
        "uniform_f64": prng.uniform(key, (d["n"],), torch.float64,
                                    device=device),
        "uniform_f32": prng.uniform(key, (d["n"],), torch.float32,
                                    device=device),
        "normal": prng.normal(key, (d["n"],), device),
        "gumbel": prng.gumbel(key, (d["n"],), device)}
    worst = 0.0
    for name, x in draws.items():
        got = x[idx].double().tolist()
        if name.startswith("uniform"):
            check(got == d[name], f"{name} differs from jax.random")
            continue
        worst = max(worst, max(_rel(a, b) for a, b in zip(got, d[name])))
    g = golden["gamma"]
    gidx = torch.tensor(g["indices"], device=device)
    gkey = tuple(g["key"])
    for name, x in (
            ("gamma_0.3", prng.gamma(gkey, 0.3, (g["n"],), device)),
            ("gamma_3.5", prng.gamma(gkey, 3.5, (g["n"],), device)),
            ("beta_2_6", prng.beta(gkey, 2.0, 6.0, (g["n"],), device))):
        got = x[gidx].tolist()
        worst = max(worst, max(_rel(a, b) for a, b in zip(got, g[name])))
    check(worst <= PRNG_DRAW_RTOL, f"kernel draws vs jax.random: {worst:.3e}")
    log(f"[prng] frozen jax.random draws at {len(d['indices'])} indices of "
        f"2^20 and {len(g['indices'])} of {g['n']}: bits and uniforms "
        f"equal, normal/gumbel/gamma/beta within {worst:.3e} (limit "
        f"{PRNG_DRAW_RTOL})")
    del draws, bits32, bits64

    # (b) The slice tape at 2^20 trials: one draw_standard launch, bit-equal
    # to the plain version, within the tolerance of the frozen JAX
    # samples; kernel and plain timed on the tape's own table.
    tree = load_tree("torch_slice_plant")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    s = golden["slice_samples"]
    key = tuple(s["key"])
    n = s["n_trials"]
    check(key == prng.prng_key(SLICE_SEED) and n == SLICE_TRIALS,
          "golden slice samples: key or trials")
    start = counters()
    with plain_draws(plain=False):
        got, tape_ms = timed_ms(lambda: tape.sample(key, n, mission, device))
    (table,) = plain_draws.tables
    check(launches_since(start)["prng"] == 1,
          "the slice tape took more than one launch")
    check(tuple(got.shape) == (n, s["n_outputs"]), "slice samples shape")
    worst = max(_rel(float(got[t, c]), v) for t, c, v in s["pairs"])
    check(worst <= PRNG_DRAW_RTOL, f"slice samples vs JAX: {worst:.3e}")
    with plain_draws():
        want, tape_plain_ms = timed_ms(
            lambda: tape.sample(key, n, mission, device))
    check(torch.equal(got, want), "slice tape: kernel differs from plain")
    err = float((got - want).abs().max())
    del want
    out = torch.empty_like(got)
    ms = cuda_ms(lambda: prng.draw_standard(table, out), 5)
    plain_ms = cuda_ms(lambda: prng.draw_standard_plain(table, out), 1)
    tape_ms = cuda_ms(lambda: tape.sample(key, n, mission, device), 3)
    b = prng_bound(table, n, clock)
    log(f"[prng] slice tape, {len(table.rows)} rows x {n} trials into "
        f"{got.shape[1]} columns: bit-equal to plain, {len(s['pairs'])} "
        f"(trial, column) pairs within {worst:.3e} of JAX; draw_standard "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms; tape.sample {tape_ms:.3f} "
        f"ms (plain draws {tape_plain_ms:.3f} ms); bound {b['bound_ms']:.3f} "
        f"ms ({b['bound_by']}: bytes {b['bytes_ms']:.3f}, integer "
        f"{b['int_ms']:.3f}, float64 {b['f64_ms']:.3f} ms)")
    record["prng"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape=f"slice tape, {len(table.rows)} rows x {n} trials", **b)
    record.setdefault("timings", {})["prng slice tape"] = {
        "tape_ms": tape_ms, "tape_plain_ms": tape_plain_ms, "ms": ms,
        "plain_ms": plain_ms, **b}
    del got, out
    torch.cuda.empty_cache()

    # (c) The every-kind tape: one draw_standard launch and one draw_gamma
    # per gamma or beta deviate, bit-equal to the plain versions.
    tape = ExpressionTape.build(every_deviate_kind(expr, MissionTime()))
    n_gamma = sum(1 for op in tape._ops
                  if op[0] in ("gamma-deviate", "beta-deviate"))
    key = prng.fold_in(prng.prng_key(SLICE_SEED), 1)
    start = counters()
    got, kind_ms = timed_ms(
        lambda: tape.sample(key, PRNG_KIND_TRIALS, mission, device))
    launches = launches_since(start)["prng"]
    check(launches == 1 + n_gamma, f"every-kind tape: {launches} launches")
    with plain_draws():
        want = tape.sample(key, PRNG_KIND_TRIALS, mission, device)
    check(torch.equal(got, want), "every-kind tape: kernel differs from "
                                  "plain")
    log(f"[prng] every-kind tape ({tape.n_outputs} outputs, {n_gamma} "
        f"gamma/beta deviates) at {PRNG_KIND_TRIALS} trials: "
        f"{1 + n_gamma} launches, bit-equal to plain, {kind_ms:.3f} ms")
    del got, want

    # (d) The path: the slice's uncertainty through the CLI, against the
    # JAX CLI's block frozen in the golden file.
    u = golden["slice_uncertainty"]
    report_path = os.path.join(OUT_DIR, "torch_slice_prng_report.json")
    argv = [SLICE_MODEL, "--device", "cuda", *u["flags"], "-o", report_path]
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(record, "prng", ("prng", "stream"))
    check(rc == 0, f"CLI exited {rc}")
    with open(report_path) as fh:
        report = json.load(fh)
    (ft,) = report["fault_trees"]
    unc = ft["uncertainty"]
    check(unc.get("method") == "bdd-stream-f32", f"method {unc.get('method')}")
    errs = _unc_errors(unc, u["block"])
    check(max(errs.values()) <= PRNG_UNC_RTOL,
          f"CLI uncertainty vs JAX: {json.dumps(errs)}")
    log(f"[prng] python -m canopy_tpu_torch {' '.join(argv)}: "
        f"{seconds:.3f} s, launches {launches}; uncertainty against the "
        f"JAX CLI's block: {json.dumps(errs)} (limit {PRNG_UNC_RTOL}); "
        f"timings {json.dumps(report['timings'])}")
    record["prng_cli_errors"] = errs


def phase_pdag(device, record: dict) -> None:
    """(c) The direct-propagation slice through ``RiskAnalysis``."""
    from canopy_tpu_torch.ops.prng import prng_key
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.analysis import RiskAnalysis
    from canopy_tpu_torch.engine.propagate import make_propagator
    from canopy_tpu_torch.engine.uncertainty import \
        sample_basic_probabilities
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings

    with open(PDAG_GOLDEN) as fh:
        golden = json.load(fh)
    settings = (Settings().algorithm("pdag").approximation("none")
                .importance_analysis(True).uncertainty_analysis(True)
                .num_trials(SLICE_TRIALS).seed(SLICE_SEED))
    model = Initializer([SLICE_MODEL], settings).model
    reset_counts()
    t0 = time.perf_counter()
    report = RiskAnalysis(model, settings, "cuda").run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(record, "pdag-slice",
                           ("stream", "stream_log", "adjoint"))
    log(f"[pdag] RiskAnalysis(pdag, approximation none, importance, "
        f"{SLICE_TRIALS} trials, seed {SLICE_SEED}, cuda): {seconds:.3f} s, "
        f"launches {launches}")
    log(f"[pdag] timings {json.dumps(report.timings)}")
    (ft,) = report.fault_trees
    check(ft.method == golden["method"], f"method {ft.method}")
    p_err = abs(ft.probability - golden["probability"]) \
        / golden["probability"]
    check(p_err <= PROB_RTOL, f"probability rel err {p_err:.3e}")
    check(ft.n_products == golden["n_products"],
          f"{ft.n_products} cut sets, golden {golden['n_products']}")
    gold_imp = golden["importance"]
    mif_max = max(v["MIF"] for v in gold_imp.values())
    worst, n_checked = 0.0, 0
    for row in ft.importance:
        want = gold_imp[row["event"]]["MIF"]
        if want > 1e-6 * mif_max:
            worst = max(worst, abs(row["MIF"] - want) / want)
            n_checked += 1
    check(worst <= PDAG_MIF_RTOL, f"MIF rel err {worst:.3e}")
    unc = ft.uncertainty
    check("method" not in unc, "the direct-propagation report gained a "
                               "method key")
    log(f"[pdag] P = {ft.probability!r} (rel err {p_err:.3e}, limit "
        f"{PROB_RTOL}); {ft.n_products} cut sets; MIF of {n_checked} "
        f"events within {worst:.3e} (limit {PDAG_MIF_RTOL}); uncertainty "
        f"mean {unc['mean']!r}")

    # Redraw the run's one batch (key prng_key(seed)) through the
    # propagator the analysis used, then hold 65,536 of its trials against
    # gather.
    tree = load_tree("torch_slice_plant")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    samples = sample_basic_probabilities(tape, prng_key(SLICE_SEED),
                                         SLICE_TRIALS,
                                         Settings().mission_time(), device)
    fn = make_propagator(tree, device, house_states=tree.house_state_vector())
    check(fn.engine == "stream", f"slice dispatch {fn.engine}")
    with torch.no_grad():
        tops = fn(samples)
        mean = float(tops.cpu().numpy().mean())
        check(mean == unc["mean"], f"redrawn batch mean {mean!r} != "
                                   f"reported {unc['mean']!r}")
        ref = make_propagator(tree, device, engine="gather")(
            samples[:AGREE_TRIALS])
    rel = float(((tops[:AGREE_TRIALS].double() - ref).abs()
                 / ref.abs()).max())
    check(rel <= TOP_RTOL, f"per-trial tops rel err {rel:.3e}")
    log(f"[pdag] {AGREE_TRIALS} sampled trials: stream tops vs f64 gather "
        f"max rel err {rel:.3e} (limit {TOP_RTOL}); redrawn batch "
        f"reproduces the reported mean exactly")
    record["pdag_seconds"] = seconds
    record["pdag_timings"] = report.timings


def replay_inputs(n_trials: int, n_basic: int, seed: int, device):
    """uniform(0, 0.05) float32 probabilities drawn by numpy in row blocks
    (the same numbers as one draw of the whole array, so the CPU can
    redraw any prefix of trials)."""
    rng = np.random.default_rng(seed)
    rows = []
    for lo in range(0, n_trials, 8192):
        block = rng.uniform(0.0, 0.05, (min(8192, n_trials - lo), n_basic))
        rows.append(torch.from_numpy(block.astype(np.float32)).to(device))
    return torch.cat(rows)


def replay_bound(enc, n_trials: int, itemsize: int, extra_rows: int,
                 backward: bool = False) -> dict:
    """Bound of a replay kernel: the basic-stream rows the program reads
    and ``extra_rows`` more rows (the top, a value log, a cotangent, the
    gradient rows), each moved once, against the op table's
    operations."""
    n_bytes = (len(enc.read_rows) + extra_rows) * n_trials * itemsize
    return bound(n_bytes, op_flops(enc, backward) * n_trials, itemsize)


def phase_replay(device, record: dict) -> None:
    """(d) The replay path: forward, staged pair, adjoint, importance."""
    from canopy_tpu_torch.engine.importance import (
        _make_replay_importance_fn, importance_measures,
        make_stream_importance_fn)
    from canopy_tpu_torch.engine.propagate import (make_propagator,
                                                   make_staged_propagator)
    from canopy_tpu_torch.ops.replay_adjoint_kernel import (
        compile_replay_adjoint, make_differentiable_replay,
        replay_adjoint_backward, replay_backward_plain, replay_level_program,
        replay_tape_forward)
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_replay_stream, encode_replay, house_tensor, level_schedule,
        replay_forward, replay_forward_plain, replay_grad_basic,
        replay_plan, replay_ring_stream, stage_basic, stage_replay,
        stream_forward, stream_variant, tree_stream_encoding)

    def ring_shape(enc, dtype, n_trials) -> dict:
        """The forward's plan, ring stream and ptxas row for a launch."""
        plan = replay_plan(enc, dtype, n_trials)
        ring = replay_ring_stream(enc, plan.depth)
        vtype = "f32" if dtype == torch.float32 else "f64"
        rows = record.get("ptxas", {})
        return {"block_trials": plan.width, "ring_depth": plan.depth,
                "chunk_words": plan.chunk_words, "chunks": ring.n_chunks,
                "shared_bytes": plan.shared_bytes, "ring_pads": ring.n_pads,
                "ring_reads": len(ring.fetches) - ring.n_pads,
                "ptxas": {log_on: rows.get(
                    f"replay_forward_kernel<{vtype},{log_on},{plan.depth}>")
                    for log_on in (0, 1)}}
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree

    t0 = time.perf_counter()
    tree = synthetic_compiled_tree(**REPLAY_TREE)
    tree16 = synthetic_compiled_tree(**ADJOINT_TREE)
    p = replay_inputs(REPLAY_RUN_TRIALS, tree.n_basic, REPLAY_SEED, device)
    p16 = replay_inputs(ADJOINT_TRIALS, tree16.n_basic, REPLAY_SEED + 1,
                        device)
    point = p16[0].double()
    house = np.zeros(0, np.float32)
    aprog = compile_replay_adjoint(tree16, max_ops_per_segment=2048)
    enc16 = encode_replay(aprog.base)
    log(f"[replay] trees ({tree.n_gates} and {tree16.n_gates} gates), "
        f"inputs and the adjoint program in "
        f"{time.perf_counter() - t0:.3f} s")

    # The path, through the entry points a user calls.
    reset_counts()
    t0 = time.perf_counter()
    fn = make_propagator(tree, device, engine="replay")
    stage, run = make_staged_propagator(tree, device, engine="replay")
    build_s = time.perf_counter() - t0
    check(fn.engine == run.engine == "replay",
          f"replay engine ran {fn.engine} / {run.engine}")
    with torch.no_grad():
        tops = fn(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = stage(p)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        tops_staged = run(staged)
    f = make_differentiable_replay(aprog, house)
    q = p16.clone().requires_grad_(True)
    value = f(stage_replay(enc16, q))
    value.sum().backward()
    imp = importance_measures(tree16, point, top_fn=_make_replay_importance_fn(
        tree16, None, device))
    launches = read_counts(record, "replay",
                           ("replay", "replay_tape", "replay_bwd"))
    log(f"[replay] make_propagator + make_staged_propagator(engine=replay) "
        f"built in {build_s:.3f} s; stage_replay {stage_s:.3f} s; "
        f"launches {launches}")

    # (a) The forward against plain, the stream kernel and gather.
    prog = compile_replay_stream(tree)
    enc = encode_replay(prog)
    T = REPLAY_RUN_TRIALS
    check(torch.equal(stage_replay(enc, p[:8]), staged[:, :8]),
          "the staged pair's stream differs from the program's")
    check(torch.equal(tops, tops_staged), "replay staged and unstaged differ")
    sizes = {"ops": enc.n_ops, "gates": enc.n_log, "pool": prog.pool_slots,
             "resident": prog.res_tiles, "segments": len(prog.segments),
             "stream_rows": prog.brs_len_pad,
             "read_rows": len(enc.read_rows), "evictions": prog.n_evicted,
             "inter": prog.n_inter, "intra": prog.n_intra,
             "slab": prog.n_slab_reads, "resident_reads":
             prog.n_resident_reads,
             "stream_gb": prog.brs_len_pad * T * 4 / 1e9,
             "log_gb": prog.n_evicted * T * 4 / 1e9}
    log(f"[replay] 65k tree program: {json.dumps(sizes)}")
    shape65 = ring_shape(enc, torch.float32, T)
    log(f"[replay] 65k tree forward at {T} f32 trials: {json.dumps(shape65)}")
    h32 = house_tensor(enc, house, device)
    plain, _ = replay_forward_plain(enc, staged, h32)
    err = float((tops_staged - plain).abs().max())
    check(err == 0.0, f"replay forward differs from plain ({err})")
    senc = tree_stream_encoding(tree)
    sstaged = stage_basic(senc, p)
    stops, _ = stream_forward(senc, sstaged, house)
    check(torch.equal(stops, tops), "replay and stream tops differ")
    gather = make_propagator(tree, device, engine="gather")
    with torch.no_grad():
        ref = gather(p[:REPLAY_AGREE].double())
    rel = float(((tops[:REPLAY_AGREE].double() - ref).abs()
                 / ref.abs()).max())
    check(rel <= TOP_RTOL, f"replay tops vs f64 gather {rel:.3e}")
    ms = cuda_ms(lambda: replay_forward(enc, staged, house), 3)
    stream_ms = cuda_ms(lambda: stream_forward(senc, sstaged, house), 3)
    plain_ms = cuda_ms(lambda: replay_forward_plain(enc, staged, h32), 1)
    variant = stream_variant(senc)
    log(f"[replay] 65k tree, {T} trials: replay kernel bit-equal to plain "
        f"and to the stream kernel ({senc.n_ops} ops, pool "
        f"{senc.pool_slots}, {variant} kernel, pool in device memory); "
        f"{REPLAY_AGREE} trials vs f64 gather max rel err {rel:.3e} "
        f"(limit {TOP_RTOL}); replay {ms:.3f} ms, stream {stream_ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms")
    record["replay"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape=f"65k tree, {enc.n_log} gates x {T} trials, f32",
        **replay_bound(enc, T, 4, 1))
    record["replay_65k"] = dict(sizes, stream_ms=stream_ms,
                                stream_pool=senc.pool_slots,
                                stream_variant=variant,
                                build_s=build_s, stage_s=stage_s,
                                **shape65)
    del staged, sstaged, plain, stops, tops, tops_staged, p, ref
    torch.cuda.empty_cache()

    # (b) Every kind of read, under a forced small schedule.
    small_prog = compile_replay_stream(tree16, **SMALL_SCHEDULE)
    counts = {k: getattr(small_prog, k) for k in (
        "n_evicted", "n_slab_reads", "n_intra", "n_inter",
        "n_resident_reads")}
    check(all(counts.values()), f"small schedule misses a read kind "
                                f"{counts}")
    small = encode_replay(small_prog)
    s_staged = stage_replay(small, p16)
    check(torch.equal(replay_forward(small, s_staged, house)[0],
                      replay_forward_plain(small, s_staged,
                                           house_tensor(small, house,
                                                        device))[0]),
          "small-schedule replay differs from plain")
    asmall = encode_replay(compile_replay_adjoint(
        tree16, pool_slots=SMALL_SCHEDULE["pool_slots"],
        max_ops_per_segment=2048).base)
    a_staged = stage_replay(asmall, p16)
    ones = torch.ones(ADJOINT_TRIALS, device=device)
    ha = house_tensor(asmall, house, device)
    top_a, vlog_a = replay_tape_forward(asmall, a_staged, house)
    ptop_a, plog_a = replay_forward_plain(asmall, a_staged, ha, True)
    check(torch.equal(top_a, ptop_a) and torch.equal(vlog_a, plog_a),
          "small-schedule taped forward differs from plain")
    check(torch.equal(
        replay_adjoint_backward(asmall, a_staged, house, vlog_a, ones),
        replay_backward_plain(asmall, a_staged, ha, plog_a, ones)),
          "small-schedule backward differs from plain")
    log(f"[replay] 16k tree, small schedule {SMALL_SCHEDULE} "
        f"({json.dumps(counts)}; adjoint program {asmall.n_evicted} "
        f"evictions): forward, taped forward and backward bit-equal to "
        f"plain at {ADJOINT_TRIALS} trials")
    del s_staged, a_staged, vlog_a, plog_a

    # (c) The adjoint at bench.py's size.
    staged16 = stage_replay(enc16, p16)
    h16 = house_tensor(enc16, house, device)
    top, vlog = replay_tape_forward(enc16, staged16, house)
    ptop, plog = replay_forward_plain(enc16, staged16, h16, True)
    tape_err = float((vlog - plog).abs().max())
    check(torch.equal(top, ptop) and tape_err == 0.0,
          "taped forward differs from plain")
    check(torch.equal(value.detach(), top), "the path's value differs")
    grad = replay_adjoint_backward(enc16, staged16, house, vlog, ones)
    pgrad = replay_backward_plain(enc16, staged16, h16, plog, ones)
    grad_err = float((grad - pgrad).abs().max())
    check(grad_err == 0.0, f"backward differs from plain ({grad_err})")
    check(torch.equal(q.grad, replay_grad_basic(enc16, grad)),
          "the path's gradient differs from the folded kernel stream")
    s64 = staged16.double().requires_grad_(True)
    (g64,) = torch.autograd.grad(
        replay_forward_plain(enc16, s64, h16.double())[0], s64,
        ones.double())
    grel = _grad_error(grad, g64)
    check(grel <= GRAD_RTOL["f32"], f"replay gradient vs f64 autograd "
                                    f"{grel:.3e}")
    ms_tape = cuda_ms(lambda: replay_tape_forward(enc16, staged16, house), 5)
    ms_bwd = cuda_ms(lambda: replay_adjoint_backward(
        enc16, staged16, house, vlog, ones), 5)
    pms_tape = cuda_ms(lambda: replay_forward_plain(enc16, staged16, h16,
                                                    True), 1)
    pms_bwd = cuda_ms(lambda: replay_backward_plain(enc16, staged16, h16,
                                                    plog, ones), 1)
    n_levels = level_schedule(replay_level_program(enc16)).n_levels
    model = level_model_ms(n_levels, sm_clock_hz())
    shape_tape = ring_shape(enc16, torch.float32, ADJOINT_TRIALS)
    log(f"[replay] 16k tree ({enc16.n_log} gates, {len(aprog.base.segments)} "
        f"segments, pool {enc16.pool_slots}, {enc16.n_evicted} evictions), "
        f"{ADJOINT_TRIALS} trials f32: taped forward and backward bit-equal "
        f"to plain; gradient vs f64 autograd {grel:.3e} (limit "
        f"{GRAD_RTOL['f32']}); tape {ms_tape:.3f} ms / plain "
        f"{pms_tape:.3f} ms ({json.dumps(shape_tape)}), backward "
        f"{ms_bwd:.3f} ms / plain {pms_bwd:.3f} ms ({n_levels} levels, "
        f"critical path {model:.4f} ms: a model)")
    shape16 = f"16k tree, {enc16.n_log} gates x {ADJOINT_TRIALS} trials, f32"
    record["replay_tape"].update(
        max_abs_err=tape_err, ms=ms_tape, plain_ms=pms_tape, shape=shape16,
        **shape_tape, **replay_bound(enc16, ADJOINT_TRIALS, 4,
                                     1 + enc16.n_log))
    record["replay_bwd"].update(
        max_abs_err=grad_err, ms=ms_bwd, plain_ms=pms_bwd, shape=shape16,
        n_levels=n_levels, critical_path_model_ms=model,
        **replay_bound(enc16, ADJOINT_TRIALS, 4,
                       enc16.n_log + 1 + len(enc16.read_rows), True))
    del staged16, vlog, plog, grad, pgrad, s64, g64, q, value

    # (c') The same kernels at importance's shape: one f64 trial.
    staged1 = stage_replay(enc16, point[None], torch.float64)
    h1 = h16.double()
    one = torch.ones(1, dtype=torch.float64, device=device)
    top, vlog = replay_tape_forward(enc16, staged1, house)
    ptop, plog = replay_forward_plain(enc16, staged1, h1, True)
    check(torch.equal(top, ptop) and torch.equal(vlog, plog),
          "taped forward differs from plain at one f64 trial")
    check(torch.equal(
        replay_adjoint_backward(enc16, staged1, house, vlog, one),
        replay_backward_plain(enc16, staged1, h1, plog, one)),
          "backward differs from plain at one f64 trial")
    ms_tape1 = cuda_ms(lambda: replay_tape_forward(enc16, staged1, house), 5)
    ms_bwd1 = cuda_ms(lambda: replay_adjoint_backward(
        enc16, staged1, house, vlog, one), 5)
    shape_one = ring_shape(enc16, torch.float64, 1)
    log(f"[replay] 16k tree, one f64 trial (importance's shape): taped "
        f"forward and backward bit-equal to plain; tape {ms_tape1:.3f} ms "
        f"({json.dumps(shape_one)}), backward {ms_bwd1:.4f} ms ({n_levels} "
        f"levels, critical path {model:.4f} ms: a model)")
    record.setdefault("timings", {})["replay-16k f64@1"] = {
        "tape_ms": ms_tape1, "backward_ms": ms_bwd1, "n_levels": n_levels,
        "critical_path_model_ms": model, **shape_one,
        "tape_bound": replay_bound(enc16, 1, 8, 1 + enc16.n_log),
        "backward_bound": replay_bound(
            enc16, 1, 8, enc16.n_log + 1 + len(enc16.read_rows), True)}
    del staged1, vlog, plog

    # (d) Importance through the replay adjoint against the stream's,
    # end to end (host clock): building the importance function (the
    # adjoint program), then the measures.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top_fn = _make_replay_importance_fn(tree16, None, device)
    t1 = time.perf_counter()
    imp = importance_measures(tree16, point, top_fn=top_fn)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    record["replay_importance_s"] = {"build": t1 - t0, "measures": t2 - t1}
    log(f"[replay] importance end to end (16k tree, one f64 trial): "
        f"_make_replay_importance_fn {t1 - t0:.3f} s, importance_measures "
        f"{t2 - t1:.3f} s")
    want = importance_measures(tree16, point, top_fn=make_stream_importance_fn(
        tree16, None, device))
    big = float(np.abs(want.mif).max())
    norm = float(np.abs(imp.mif - want.mif).max()) / big
    sel = np.abs(want.mif) > 1e-6 * big
    per = float((np.abs(imp.mif - want.mif)[sel]
                 / np.abs(want.mif[sel])).max())
    check(norm <= REPLAY_MIF_RTOL and per <= REPLAY_MIF_RTOL,
          f"replay MIF vs stream: normwise {norm:.3e}, per event {per:.3e}")
    log(f"[replay] importance (f64, one trial): P = {imp.top_probability!r} "
        f"(stream {want.top_probability!r}); MIF vs the stream adjoint "
        f"normwise {norm:.3e}, per event above 1e-6 of the largest "
        f"({int(sel.sum())} events) {per:.3e} (limit {REPLAY_MIF_RTOL})")
    torch.cuda.empty_cache()


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def timed_ms(fn):
    """``(fn(), its milliseconds)`` by CUDA events around one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bernoulli_bound(n_events: int, n_words: int, clock_hz: float) -> dict:
    """The Philox kernel's bound: its integer operations over the card's
    int32 lanes at the SM clock, against the words written (and the
    thresholds read) over the memory rate."""
    t_bytes = (n_events * n_words + n_events) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = n_events * n_words * BERN_CLOCKS_PER_WORD \
        / (N_SMS * clock_hz) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def philox_probe(device, clock_hz: float, slice_words: int,
                 record: dict) -> None:
    """Time ``tools/philox_rate.cu`` (built in phase 2): the rate the card
    reaches on the Philox kernel's integer work alone, in words, source
    operations and SASS instructions per clock and SM, and the time of
    the slice shape's words at that rate beside the kernel's and the
    bound's."""
    import ctypes
    lib = ctypes.CDLL(PHILOX_PROBE_LIB)
    u32, i32, vp = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    lib.canopy_philox_rate.argtypes = [u32, u32, u32, i32, i32, i32, vp, vp]
    lib.canopy_philox_rate.restype = i32
    blocks, threads = PHILOX_PROBE_SHAPE
    words = blocks * threads * PHILOX_PROBE_REPS
    folded = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        code = lib.canopy_philox_rate(
            0x80000000, MC_SEED & 0xFFFFFFFF, MC_SEED >> 32,
            PHILOX_PROBE_REPS, blocks, threads, folded.data_ptr(), stream)
        check(code == 0, f"Philox probe: CUDA error {code}")
    ms = cuda_ms(run, 5)
    per_clock = words / (ms * 1e-3 * clock_hz * N_SMS)
    sass = record["bernoulli_sass"]["probe"]
    rates = {"words": per_clock,
             "source_ops": per_clock * (BERN_PRODUCTS_PER_WORD +
                                        BERN_ALU_OPS_PER_WORD)}
    if sass is not None:
        rates["sass_instructions"] = per_clock * sass["per_word_total"]
        for kind in ("IMAD.WIDE", "LOP3", "ISETP"):
            rates[kind] = per_clock * sass["per_word"].get(kind, 0)
    at_rate_ms = slice_words / words * ms
    # Each pipe alone, then both: instructions per clock and SM.
    lib.canopy_pipe_rate.argtypes = [i32, i32, i32, i32, vp, vp]
    lib.canopy_pipe_rate.restype = i32
    p_blocks, p_threads = PIPE_PROBE_SHAPE
    pipe_out = torch.empty(p_blocks * p_threads, dtype=torch.int32,
                           device=device)
    pipes = {}
    for mode, label in enumerate(("IMAD.WIDE alone", "LOP3 alone",
                                  "IMAD.WIDE + LOP3")):
        def run_pipe(mode=mode):
            code = lib.canopy_pipe_rate(mode, PIPE_PROBE_REPS, p_blocks,
                                        p_threads, pipe_out.data_ptr(),
                                        stream)
            check(code == 0, f"pipe probe {mode}: CUDA error {code}")
        pipe_ms = cuda_ms(run_pipe, 5)
        n_ops = p_blocks * p_threads * PIPE_PROBE_REPS * 32 * \
            (2 if mode == 2 else 1)
        pipes[label] = {"ms": pipe_ms, "instructions": n_ops,
                        "per_clock_per_sm": n_ops / (pipe_ms * 1e-3 *
                                                     clock_hz * N_SMS)}
    # The bound's rates may not be below what the card reaches.
    check(pipes["IMAD.WIDE alone"]["per_clock_per_sm"] <=
          WIDE_PRODUCTS_PER_CLOCK and
          pipes["LOP3 alone"]["per_clock_per_sm"] <= ALU_LANES and
          at_rate_ms >= record["bernoulli"]["bound_ms"],
          f"the Philox bound's rates are below the card's: {pipes}, "
          f"{at_rate_ms} ms at the probe's rate")
    pipe_rates = {k: round(v["per_clock_per_sm"], 3)
                  for k, v in pipes.items()}
    log(f"[mc] pipe probe ({p_blocks} x {p_threads} threads x "
        f"{PIPE_PROBE_REPS} trips), instructions per clock and SM: "
        f"{json.dumps(pipe_rates)}")
    log(f"[mc] Philox probe ({blocks} x {threads} threads x "
        f"{PHILOX_PROBE_REPS} words): {ms:.3f} ms for {words} words; per "
        f"clock and SM at {clock_hz / 1e6:.0f} MHz: "
        f"{json.dumps({k: round(v, 3) for k, v in rates.items()})}; the "
        f"slice shape's {slice_words} words at this rate {at_rate_ms:.3f} "
        f"ms, the kernel {record['bernoulli']['ms']:.3f} ms, the bound "
        f"{record['bernoulli']['bound_ms']:.3f} ms")
    record.setdefault("timings", {})["philox probe"] = {
        "ms": ms, "words": words, "per_clock_per_sm": rates,
        "slice_words_at_probe_rate_ms": at_rate_ms, "pipes": pipes}


def mean_probabilities(tree, device) -> torch.Tensor:
    """The tree's clamped mean basic-event probabilities, as the analysis
    evaluates them."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.settings import Settings
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    return torch.clamp(tape.evaluate_mean(Settings().mission_time(), device),
                       0.0, 1.0)


def phase_mc(device, record: dict) -> None:
    """(9a-d) The Philox kernel, then the Monte Carlo path: the slice
    through the CLI, the golden anchors through ``RiskAnalysis``, the
    plant tree through ``packed_top_probability``."""
    from canopy_tpu_torch.cli import main as cli_main
    from canopy_tpu_torch.engine.analysis import RiskAnalysis
    from canopy_tpu_torch.engine.sampler import monte_carlo_ci
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.ops.bernoulli_kernel import (packed_bernoulli,
                                                       packed_bernoulli_plain)
    from canopy_tpu_torch.ops.bitpack import packed_top_probability
    from canopy_tpu_torch.settings import Settings
    from canopy_tpu_torch.utils.synthetic import synthetic_hierarchical_tree

    with open(os.path.join(FIXTURES, "golden.json")) as fh:
        golden = json.load(fh)
    with open(SLICE_GOLDEN) as fh:
        slice_exact = json.load(fh)["exact_probability"]
    clock = sm_clock_hz()
    t0 = time.perf_counter()
    plant_gold = golden["plant_hier_9363"]
    plant = synthetic_hierarchical_tree(**plant_gold["generator"])
    check((plant.n_gates, plant.nnz) == (plant_gold["n_gates"],
                                         plant_gold["nnz"]),
          f"plant tree {plant.n_gates} gates, {plant.nnz} edges")
    plant_p = torch.from_numpy(np.random.default_rng(42).uniform(
        1e-4, 5e-3, plant.n_basic)).to(device)
    slice_p = mean_probabilities(load_tree("torch_slice_plant"), device)
    log(f"[mc] plant tree ({plant.n_gates} gates, {plant.n_basic} basics) "
        f"in {time.perf_counter() - t0:.3f} s; SM clock {clock / 1e6:.0f} "
        f"MHz")

    # (a) The kernel against its plain version, outside the counted path.
    for label, p, n_words in (("slice", slice_p, BERN_SLICE_WORDS),
                              ("plant", plant_p, BERN_PLANT_WORDS)):
        n = 32 * n_words
        got = packed_bernoulli(MC_SEED, p, n)
        want, plain_ms = timed_ms(
            lambda: packed_bernoulli_plain(MC_SEED, p, n))
        # Words compared as 64-bit integers (the plant shape's 2^31 words
        # only for equality: their difference would take 17 GB).
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs()
                    .max()) if label == "slice" else \
            (0.0 if torch.equal(got, want) else float("inf"))
        check(err == 0.0, f"{label}: Bernoulli kernel differs from plain")
        ms = cuda_ms(lambda: packed_bernoulli(MC_SEED, p, n), 5)
        b = bernoulli_bound(len(p), n_words, clock)
        log(f"[mc] Bernoulli {label}: {len(p)} events x {n_words} words "
            f"bit-equal to plain; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
        record.setdefault("timings", {})[f"bernoulli {label}"] = {
            "ms": ms, "plain_ms": plain_ms, **b}
        if label == "slice":
            record["bernoulli"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"slice, {len(p)} events x {n_words} words "
                      f"({n} trials)", **b)
        del got, want
    torch.cuda.empty_cache()
    philox_probe(device, clock, len(slice_p) * BERN_SLICE_WORDS, record)

    # The path: (b) the CLI, (c) the golden anchors, (d) the plant tree.
    reset_counts()
    report_path = os.path.join(OUT_DIR, "torch_slice_mc_report.json")
    argv = [SLICE_MODEL, "--device", device.type, "--monte-carlo",
            "--probability", "--num-trials", str(MC_SLICE_TRIALS), "--seed",
            str(MC_SEED), "-o", report_path]
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"Monte Carlo CLI exited {rc}")
    with open(report_path) as fh:
        report = json.load(fh)
    (ft,) = report["fault_trees"]
    n = MC_SLICE_TRIALS
    band = 6 * (slice_exact * (1 - slice_exact) / n) ** 0.5 + 1e-4
    err = abs(ft["probability"] - slice_exact)
    check(ft["method"] == "bdd/monte_carlo", f"method {ft['method']}")
    check(err <= band, f"slice Monte Carlo {ft['probability']!r} vs exact "
                       f"{slice_exact!r}: {err:.3e} > {band:.3e}")
    check(ft["mc_std_error"] == monte_carlo_ci(ft["probability"], n),
          "the reported standard error is not the formula's")
    log(f"[mc] python -m canopy_tpu_torch {' '.join(argv)}: {cli_s:.3f} s; "
        f"P = {ft['probability']!r} (exact {slice_exact!r}, |err| "
        f"{err:.3e} <= {band:.3e}), standard error "
        f"{ft['mc_std_error']!r}; timings {json.dumps(report['timings'])}")
    anchors = {}
    for name in sorted(golden):
        gold = golden[name]
        if "mc_4sigma" not in gold or gold.get("kind", "fault_tree") \
                != "fault_tree":
            continue
        # Products are skipped: MOCUS on the nested-count anchor's 753
        # count gates runs for minutes on the host; this checks the
        # estimate.
        settings = (Settings().probability_analysis(True)
                    .approximation("monte-carlo")
                    .num_trials(gold["mc_trials"]).seed(MC_SEED)
                    .skip_products(True).ccf_analysis(True))
        model = Initializer([os.path.join(FIXTURES, f"{name}.xml")],
                            settings).model
        t0 = time.perf_counter()
        (res,) = RiskAnalysis(model, settings, device).run().fault_trees
        seconds = time.perf_counter() - t0
        err = abs(res.probability - gold["exact_probability"])
        check(err <= gold["mc_4sigma"],
              f"{name}: Monte Carlo {res.probability!r} vs exact "
              f"{gold['exact_probability']!r}: {err:.3e} > "
              f"{gold['mc_4sigma']:.3e}")
        anchors[name] = {"estimate": res.probability, "err": err,
                         "band": gold["mc_4sigma"], "seconds": seconds}
        log(f"[mc] {name}: {gold['mc_trials']} trials, P = "
            f"{res.probability!r} (exact {gold['exact_probability']!r}, "
            f"|err| {err:.3e} <= {gold['mc_4sigma']:.3e}), {seconds:.3f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    t0 = time.perf_counter()
    estimate = packed_top_probability(plant, MC_SEED, plant_p,
                                      plant_gold["mc_trials"], None, device,
                                      stats=stats)
    torch.cuda.synchronize()
    plant_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(record, "mc", ("bernoulli",))
    err = abs(estimate - plant_gold["exact_probability"])
    check(err <= plant_gold["mc_4sigma"],
          f"plant_hier_9363: Monte Carlo {estimate!r} vs exact "
          f"{plant_gold['exact_probability']!r}: {err:.3e}")
    log(f"[mc] plant_hier_9363: {plant_gold['mc_trials']} trials in "
        f"{stats['chunks']} chunks of {stats['chunk_words']} words, "
        f"{plant_s:.3f} s, peak {peak / 2**30:.2f} GiB; P = {estimate!r} "
        f"(exact {plant_gold['exact_probability']!r}, |err| {err:.3e} <= "
        f"{plant_gold['mc_4sigma']:.3e}); launches {launches}")
    # The plant's sampling alone, chunk by chunk as the path ran it.
    sample_ms = 0.0
    for w0 in range(0, stats["n_words"], stats["chunk_words"]):
        words = min(stats["chunk_words"], stats["n_words"] - w0)
        out, ms = timed_ms(lambda: packed_bernoulli(MC_SEED, plant_p,
                                                    32 * words, w0))
        del out
        sample_ms += ms
    log(f"[mc] plant_hier_9363: the Bernoulli kernel alone over its chunks "
        f"{sample_ms:.3f} ms of {plant_s * 1e3:.1f} ms")
    record["mc"] = {"cli_s": cli_s, "cli_timings": report["timings"],
                    "slice_estimate": ft["probability"], "anchors": anchors,
                    "plant": dict(stats, estimate=estimate, seconds=plant_s,
                                  peak_bytes=peak, sample_ms=sample_ms)}
    torch.cuda.empty_cache()


def spill_bound(enc, n_trials: int) -> dict:
    """The spill kernel's bound: the staged rows it reads, its scratch
    stores and reloads and the top, each moved once, against the op
    table's operations."""
    from canopy_tpu_torch.ops.stream_kernel import STAGED
    staged_rows = len(np.unique(enc.args[enc.args[:, 0] == STAGED, 1]))
    rows = staged_rows + enc.counts["evictions"] \
        + enc.counts["scratch_refills"] + 1
    return bound(rows * n_trials * 4, op_flops(enc) * n_trials, 4)


def phase_spill(device, record: dict) -> None:
    """(9e-f) The spill engine (the ring kernel) on the 65k replay tree
    beside the replay and stream kernels on the same inputs, and a forced
    small schedule with every op kind."""
    from canopy_tpu_torch.engine.propagate import make_propagator
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_replay_stream, compile_spill_stream, encode_replay,
        encode_spill, house_tensor, replay_forward, replay_plan,
        replay_ring_stream, spill_forward, spill_forward_plain, stage_basic,
        stage_replay, stream_forward, tree_stream_encoding)

    def ring_plan(enc, n_trials: int) -> dict:
        plan = replay_plan(enc, torch.float32, n_trials)
        ring = replay_ring_stream(enc, plan.depth)
        return {"block_trials": plan.width, "ring_depth": plan.depth,
                "pool": enc.pool_slots, "shared_bytes": plan.shared_bytes,
                "chunks": ring.n_chunks, "ring_pads": ring.n_pads,
                "ring_reads": len(ring.fetches) - ring.n_pads,
                "ptxas": record.get("ptxas", {}).get(
                    f"replay_forward_kernel<f32,0,{plan.depth}>@spill.cu")}
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree

    tree = synthetic_compiled_tree(**REPLAY_TREE)
    p = replay_inputs(REPLAY_RUN_TRIALS, tree.n_basic, REPLAY_SEED, device)
    house = np.zeros(0, np.float32)
    reset_counts()
    t0 = time.perf_counter()
    fn = make_propagator(tree, device, engine="spill")
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        tops = fn(p)
    launches = read_counts(record, "spill", ("spill",))
    check(fn.engine == "spill", f"spill engine ran {fn.engine}")
    log(f"[spill] make_propagator(engine=spill) built in {build_s:.3f} s; "
        f"launches {launches}")

    prog = compile_spill_stream(tree)
    enc = encode_spill(prog)
    T = REPLAY_RUN_TRIALS
    sizes = {"ops": enc.n_ops, "gates": enc.n_log, "pool": prog.pool_slots,
             "segments": len(prog.segments), "staged_rows": enc.n_basic,
             "scratch_rows": enc.n_scratch, **enc.counts,
             "scratch_gb": enc.n_scratch * T * 4 / 1e9}
    log(f"[spill] 65k tree program: {json.dumps(sizes)}")
    plan = ring_plan(enc, T)
    log(f"[spill] 65k tree ring plan at {T} f32 trials: {json.dumps(plan)}")
    staged = stage_basic(enc, p)
    h32 = house_tensor(enc, house, device)
    plain = spill_forward_plain(enc, staged, h32)
    err = float((tops - plain).abs().max())
    check(err == 0.0, f"spill forward differs from plain ({err})")
    senc = tree_stream_encoding(tree)
    sstaged = stage_basic(senc, p)
    stops, _ = stream_forward(senc, sstaged, house)
    check(torch.equal(stops, tops), "spill and stream tops differ")
    gather = make_propagator(tree, device, engine="gather")
    with torch.no_grad():
        ref = gather(p[:REPLAY_AGREE].double())
    rel = float(((tops[:REPLAY_AGREE].double() - ref).abs()
                 / ref.abs()).max())
    check(rel <= TOP_RTOL, f"spill tops vs f64 gather {rel:.3e}")
    ms = cuda_ms(lambda: spill_forward(enc, staged, house), 3)
    stream_ms = cuda_ms(lambda: stream_forward(senc, sstaged, house), 3)
    plain_ms = cuda_ms(lambda: spill_forward_plain(enc, staged, h32), 1)
    del sstaged, stops
    # The replay kernel on the same tree and inputs (its default program).
    renc = encode_replay(compile_replay_stream(tree))
    rstaged = stage_replay(renc, p)
    check(torch.equal(replay_forward(renc, rstaged, house)[0], tops),
          "replay and spill tops differ")
    replay_ms = cuda_ms(lambda: replay_forward(renc, rstaged, house), 3)
    del rstaged
    b = spill_bound(enc, T)
    log(f"[spill] 65k tree, {T} trials: spill kernel bit-equal to plain, "
        f"to the stream kernel and to the replay kernel; {REPLAY_AGREE} "
        f"trials vs f64 gather max rel err {rel:.3e} (limit {TOP_RTOL}); "
        f"spill {ms:.3f} ms, replay {replay_ms:.3f} ms ({renc.n_ops} ops, "
        f"pool {renc.pool_slots}), stream {stream_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    record["spill"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape=f"65k tree, {enc.n_log} gates x {T} trials, f32", **b)
    record["spill_65k"] = dict(sizes, stream_ms=stream_ms,
                               replay_ms=replay_ms, build_s=build_s,
                               plan=plan)
    del staged, plain, tops, p, ref
    torch.cuda.empty_cache()

    # (f) Every op kind, under a forced small schedule.
    tree16 = synthetic_compiled_tree(**ADJOINT_TREE)
    small = encode_spill(compile_spill_stream(tree16, **SPILL_SMALL))
    check(all(small.counts.values()) and small.counts["segments"] > 1,
          f"small spill schedule misses an op kind {small.counts}")
    p16 = replay_inputs(ADJOINT_TRIALS, tree16.n_basic, REPLAY_SEED + 1,
                        device)
    s16 = stage_basic(small, p16)
    check(torch.equal(spill_forward(small, s16, house), spill_forward_plain(
        small, s16, house_tensor(small, house, device))),
          "small-schedule spill differs from plain")
    small_plan = ring_plan(small, ADJOINT_TRIALS)
    log(f"[spill] 16k tree, small schedule {SPILL_SMALL} ({small.n_ops} "
        f"ops, {json.dumps(small.counts)}, {small.n_scratch} scratch rows; "
        f"ring plan {json.dumps(small_plan)}): kernel bit-equal to plain at "
        f"{ADJOINT_TRIALS} trials")
    record["spill_small"] = dict(small.counts, ops=small.n_ops,
                                 scratch_rows=small.n_scratch,
                                 plan=small_plan)


def gather_f32(tree, p: torch.Tensor) -> torch.Tensor:
    """The float32 gather engine's tops, in trial slabs (its arithmetic is
    per trial, so the bits are one call's)."""
    from canopy_tpu_torch.engine.propagate import make_propagator
    fn = make_propagator(tree, p.device, engine="gather")
    with torch.no_grad():
        return torch.cat([fn(s) for s in p.split(BLOCK_SLAB)])


def level_bound(rows: int, n_trials: int, transcendentals: int,
                flops: int, clock_hz: float) -> dict:
    """A level kernel's bound: ``rows`` float32 rows of ``n_trials`` over
    the memory rate, against its logs and exps over the special-function
    units at the SM clock and its other operations over the float32
    peak."""
    t_bytes = rows * n_trials * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (transcendentals * n_trials / (SFU_LANES * clock_hz)
             + flops * n_trials / PEAK_FLOPS[4]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_block(device, record: dict) -> None:
    """(10) The locality-reordered plant tree: the path ``block`` (the
    block engine and the direct mode), BSR and the stream for context,
    then the path ``gather``."""
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.compiler.reorder import (locality_reorder,
                                                   random_shuffle)
    from canopy_tpu_torch.engine.propagate import (make_propagator,
                                                   top_event_probability)
    from canopy_tpu_torch.errors import LogicError
    from canopy_tpu_torch.ops.block_gather import (
        auto_t_tile, block_gather_forward_plain, block_gather_levels,
        block_gather_propagate, compile_block_gather, stage_block_gather)
    from canopy_tpu_torch.ops.bsr_propagate import (bsr_arrays,
                                                    bsr_top_probability,
                                                    compile_bsr)
    from canopy_tpu_torch.ops.gather_kernel import (gather_forward_plain,
                                                    gather_levels,
                                                    gather_propagate,
                                                    stage_gather)
    from canopy_tpu_torch.ops.stream_kernel import (stage_basic,
                                                    stream_forward,
                                                    tree_stream_encoding)
    from canopy_tpu_torch.utils.synthetic import (synthetic_hierarchical_tree,
                                                  synthetic_mef_tree)

    with open(os.path.join(FIXTURES, "golden.json")) as fh:
        gold = json.load(fh)["plant_hier_9363"]
    clock = sm_clock_hz()
    plant = synthetic_hierarchical_tree(**gold["generator"])
    check((plant.n_gates, plant.nnz) == (gold["n_gates"], gold["nnz"]),
          f"plant tree {plant.n_gates} gates, {plant.nnz} edges")
    shuffled = random_shuffle(plant, seed=1)
    t0 = time.perf_counter()
    ordered = locality_reorder(shuffled.tree, hot_first=True)
    reorder_s = time.perf_counter() - t0
    tree = ordered.tree
    try:
        make_propagator(shuffled.tree, device, engine="block")
    except LogicError as err:
        refused = str(err)
    else:
        raise AssertionError("engine='block' took the unreordered tree")
    T = BLOCK_TRIALS
    gen = torch.Generator(device=device).manual_seed(BLOCK_SEED)
    p = torch.rand((T, tree.n_basic), generator=gen, device=device) \
        .mul_(5e-3 - 1e-4).add_(1e-4)
    log(f"[block] plant tree {plant.n_gates} gates, {plant.nnz} edges; "
        f"reorder {reorder_s:.3f} s; the shuffled tree refused: {refused}")

    # The path: the block engine (log kernel) and the direct mode.
    reset_counts()
    t0 = time.perf_counter()
    fn = make_propagator(tree, device, engine="block")
    build_s = time.perf_counter() - t0
    program = compile_block_gather(tree)
    with torch.no_grad():
        tops, path_ms = timed_ms(lambda: fn(p))
        direct = block_gather_propagate(program, p, mode="direct")
    launches = read_counts(record, "block", ("block_log", "block_direct"))
    check(fn.engine == "block", f"block engine ran {fn.engine}")
    levels = [{"gates": lv.n_gates, "r_rows": lv.r_rows,
               "resident_slabs": len(lv.resident_rows), "c_rows": lv.c_rows}
              for lv in program.levels]
    width = auto_t_tile(program)
    log(f"[block] make_propagator(engine=block) built in {build_s:.3f} s, "
        f"ran {path_ms:.3f} ms (staging included); levels {levels}; "
        f"{width} trials per block; launches {launches}")

    plain_log, plain_log_ms = timed_ms(
        lambda: block_gather_forward_plain(program, p, "log"))
    log_err = float((tops - plain_log).abs().max())
    rel = float(((tops - plain_log).abs() / plain_log).max())
    n_same = int((tops == plain_log).sum())
    check(rel <= BLOCK_LOG_RTOL, f"log kernel vs plain {rel:.3e}")
    plain_direct, plain_direct_ms = timed_ms(
        lambda: block_gather_forward_plain(program, p, "direct"))
    direct_err = float((direct - plain_direct).abs().max())
    check(torch.equal(direct, plain_direct), "direct kernel differs from "
                                             "plain")
    g32 = gather_f32(tree, p)
    check(torch.equal(direct, g32), "direct kernel differs from the "
                                    "float32 gather engine")
    gather64 = make_propagator(tree, device, engine="gather")
    with torch.no_grad():
        ref = gather64(p[:BLOCK_AGREE].double())
    rel64 = float(((tops[:BLOCK_AGREE].double() - ref).abs()
                   / ref.abs()).max())
    check(rel64 <= TOP_RTOL, f"block tops vs f64 gather {rel64:.3e}")
    del plain_log, plain_direct, ref, direct
    vals = stage_block_gather(program, p)
    log_ms = cuda_ms(lambda: block_gather_levels(program, vals, width,
                                                 "log"), 5)
    direct_ms = cuda_ms(lambda: block_gather_levels(program, vals, width,
                                                    "direct"), 5)
    del vals
    torch.cuda.empty_cache()
    rows = sum(program.hbm_rows_per_level())
    b_log = level_bound(rows, T, tree.nnz + tree.n_gates,
                        2 * tree.nnz + 3 * tree.n_gates, clock)
    b_direct = level_bound(rows, T, 0, 4 * tree.nnz + 3 * tree.n_gates,
                           clock)
    log(f"[block] log kernel within {rel:.3e} of plain ({n_same} of {T} "
        f"trials bit-equal), {BLOCK_AGREE} trials vs f64 gather {rel64:.3e}"
        f" (limit {TOP_RTOL}); direct bit-equal to plain and to the f32 "
        f"gather engine; levels alone: log {log_ms:.3f} ms, direct "
        f"{direct_ms:.3f} ms; plain {plain_log_ms:.3f} and "
        f"{plain_direct_ms:.3f} ms; bound {b_log['bound_ms']:.3f} ms "
        f"({b_log['bound_by']}, {rows} rows), direct "
        f"{b_direct['bound_ms']:.3f} ms ({b_direct['bound_by']})")
    shape = f"reordered plant tree, {tree.n_gates} gates x {T} trials, f32"
    record["block_log"].update(max_abs_err=log_err, ms=log_ms,
                               plain_ms=plain_log_ms, shape=shape, **b_log)
    record["block_direct"].update(max_abs_err=direct_err, ms=direct_ms,
                                  plain_ms=plain_direct_ms, shape=shape,
                                  **b_direct)

    # BSR on the shuffled tree reordered by estimated fill; its inputs are
    # the same trials with the basic events in that tree's order.
    t0 = time.perf_counter()
    auto = locality_reorder(shuffled.tree, method="auto")
    bprog = compile_bsr(auto.tree)
    auto_s = time.perf_counter() - t0
    src = np.empty(tree.n_basic, dtype=np.int64)
    src[auto.perm[:tree.n_basic]] = ordered.perm[:tree.n_basic]
    src_t = torch.from_numpy(src).to(device)
    params = bsr_arrays(bprog, device)

    def run_bsr():
        return torch.cat([bsr_top_probability(
            bprog, s.index_select(1, src_t), t_chunk=BSR_T_CHUNK,
            params=params) for s in p.split(BLOCK_SLAB)])
    with torch.no_grad():
        run_bsr()
        bsr_tops, bsr_ms = timed_ms(run_bsr)
    bsr_rel = float(((bsr_tops - g32).abs() / g32).max())
    check(bsr_rel <= BSR_RTOL, f"BSR vs the f32 gather engine {bsr_rel:.3e}")
    del bsr_tops, params
    torch.cuda.empty_cache()
    # For context: the stream kernel on the same inputs.
    enc = tree_stream_encoding(tree)
    staged = stage_basic(enc, p)
    stream_tops, _ = stream_forward(enc, staged, [])
    stream_same = bool(torch.equal(stream_tops, g32))
    stream_ms = cuda_ms(lambda: stream_forward(enc, staged, [])[0], 3)
    del staged, stream_tops
    torch.cuda.empty_cache()
    log(f"[block] BSR (method=auto, reorder and compile {auto_s:.3f} s, "
        f"{bprog.fill_blocks} tiles, fill {bprog.fill_ratio:.1f}): "
        f"{bsr_ms:.3f} ms, within {bsr_rel:.3e} of the f32 gather engine "
        f"(limit {BSR_RTOL}); stream kernel {stream_ms:.3f} ms "
        f"({enc.n_ops} ops, {enc.pool_slots} slots; tops equal to the "
        f"f32 gather engine: {stream_same})")

    # The path: the gather level kernel on the plant tree and a ragged one.
    top, _ = synthetic_mef_tree(**RAGGED_TREE)
    ragged = compile_gates([top])
    ragged.top_index = ragged.gate_index[top.id]
    check(any(not b.arg_mask.all() for lv in ragged.levels
              for b in lv.prods), "the ragged tree has no padded position")
    pr = torch.rand((T, ragged.n_basic), generator=gen, device=device) \
        .mul_(0.45).add_(0.05)
    reset_counts()
    with torch.no_grad():
        g_tops, g_path_ms = timed_ms(lambda: gather_propagate(tree, p))
        r_tops = gather_propagate(ragged, pr)
    g_launches = read_counts(record, "gather", ("gather",))
    check(torch.equal(g_tops, g32), "gather kernel differs from the f32 "
                                    "gather engine")
    g_plain, g_plain_ms = timed_ms(lambda: gather_forward_plain(tree, p))
    g_err = float((g_tops - g_plain).abs().max())
    check(torch.equal(g_tops, g_plain), "gather kernel differs from plain")
    del g_plain
    check(torch.equal(r_tops, gather_forward_plain(ragged, pr)),
          "ragged tree: gather kernel differs from plain")
    with torch.no_grad():
        check(torch.equal(r_tops, top_event_probability(ragged, pr)),
              "ragged tree: gather kernel differs from the f32 gather "
              "engine")
    vals = stage_gather(tree, p)
    g_ms = cuda_ms(lambda: gather_levels(tree, vals), 5)
    del vals
    b_g = level_bound(tree.nnz + tree.n_gates, T, 0,
                      2 * tree.nnz + tree.n_gates, clock)
    log(f"[gather] plant tree at {T} trials: {g_path_ms:.3f} ms with "
        f"staging, levels alone {g_ms:.3f} ms, plain {g_plain_ms:.3f} ms, "
        f"bound {b_g['bound_ms']:.3f} ms ({b_g['bound_by']}); bit-equal to "
        f"plain and to the f32 gather engine; the ragged tree "
        f"({ragged.n_gates} gates) bit-equal to both at {T} trials; "
        f"launches {g_launches}")
    record["gather"].update(max_abs_err=g_err, ms=g_ms, plain_ms=g_plain_ms,
                            shape=shape, **b_g)
    record["block_plant"] = {
        "levels": levels, "hbm_rows": rows, "trials_per_block": width,
        "reorder_s": reorder_s, "build_s": build_s, "path_ms": path_ms,
        "log_rel_plain": rel, "log_bit_equal_trials": n_same,
        "log_rel_f64": rel64, "bsr_ms": bsr_ms, "bsr_rel": bsr_rel,
        "bsr_tiles": bprog.fill_blocks, "auto_reorder_s": auto_s,
        "stream_ms": stream_ms, "stream_equal_f32_gather": stream_same,
        "gather_path_ms": g_path_ms}
    del p, pr, g_tops, r_tops, g32, tops
    torch.cuda.empty_cache()


def _rel(got: float, want: float) -> float:
    return 0.0 if got == want else abs(got - want) / abs(want)


def _fault_tree_values(report: dict) -> dict:
    """A report's fault-tree probabilities keyed as
    ``torch_event_tree_golden.json`` keys them."""
    return {(r["top_event"] if "phase" not in r else
             f"{r['top_event']}@{r['alignment']}/{r['phase']}"):
            r["probability"] for r in report["fault_trees"]}


def _run_cli(argv: list, label: str) -> tuple[dict, float]:
    """(JSON report, wall seconds) of the CLI in-process on ``argv``."""
    from canopy_tpu_torch.cli import main as cli_main
    path = os.path.join(OUT_DIR, f"et_{label}.json")
    t0 = time.perf_counter()
    rc = cli_main([*argv, "-o", path])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{label}: CLI exited {rc}")
    with open(path) as fh:
        return json.load(fh), seconds


def _event_tree_inputs(paths: list):
    """(compiled tree, root slots in sequence order, sampling tape, its
    key, mission time) of a model's one event tree, rebuilt as the
    analysis builds them."""
    from canopy_tpu_torch.ops.prng import fold_in, prng_key
    import zlib

    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.compiler.graph import compile_gates
    from canopy_tpu_torch.engine.event_tree_walk import walk_event_tree
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    settings = Settings()
    model = Initializer(paths, settings).model
    (ie,) = model.initiating_events
    outcomes = walk_event_tree(model, ie)
    gates = [g for g in (o.conjoined_gate(f"__seq{i}__")
                         for i, o in enumerate(outcomes)) if g is not None]
    tree = compile_gates(gates, use_ccf=settings.ccf_analysis())
    tape = ExpressionTape.build(
        [e.expression for e in tree.basic_events] +
        [e for o in outcomes for e in o.expressions])
    key = fold_in(prng_key(ET_SEED),
                  zlib.crc32(ie.name.encode()) & 0x7FFFFFFF)
    return (tree, [tree.gate_index[g.id] for g in gates], tape, key,
            settings.mission_time())


def _fault_tree_modules(paths: list) -> int:
    """Stream launches of a model's fault-tree uncertainty analyses on
    CUDA: one per BDD module whose root is not a constant."""
    from canopy_tpu_torch.compiler.graph import compile_fault_tree
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    n = 0
    for fault_tree in Initializer(paths, Settings()).model.fault_trees:
        tree = compile_fault_tree(fault_tree)
        modular = build_modular_bdd(tree,
                                    house_states=tree.house_state_vector())
        n += sum(1 for bdd, _slot in modular.chain
                 if bdd.resolved_root() > 1)
    return n


def phase_et(device, record: dict) -> None:
    """(11a-c) Event trees, alignment phases and SIL through the CLI."""
    from canopy_tpu_torch.compiler.bdd import build_bdd_multi
    from canopy_tpu_torch.engine.bdd_eval import (bdd_probability,
                                                  make_bdd_evaluator)
    from canopy_tpu_torch.ops.stream_kernel import (bdd_stream_encoding,
                                                    house_tensor,
                                                    stage_basic,
                                                    stream_forward_plain,
                                                    stream_propagate_staged)
    from canopy_tpu_torch.utils.scale_models import event_tree_scale_xml

    with open(ET_GOLDEN) as fh:
        golden = json.load(fh)
    out: dict = {"fixtures": {}}

    # (a) The event-tree and alignment fixtures, then the SIL slice.
    reset_counts()
    for name, want in sorted(golden["fixtures"].items()):
        report, seconds = _run_cli(
            [os.path.join(FIXTURES, f"{name}.xml"), "--device",
             device.type, "--probability"], name)
        got_seq = {s["sequence"]: s["probability"]
                   for s in report["sequences"]}
        got_ft = _fault_tree_values(report)
        check(set(got_seq) == set(want["sequences"]) and
              set(got_ft) == set(want["fault_trees"]),
              f"{name}: results {sorted(got_seq)} {sorted(got_ft)}")
        worst = max([_rel(got_seq[k], v) for k, v in
                     want["sequences"].items()] +
                    [_rel(got_ft[k], v) for k, v in
                     want["fault_trees"].items()])
        check(worst <= PROB_RTOL, f"{name}: rel err {worst:.3e}")
        log(f"[et] {name} through the CLI: {len(got_seq)} sequences, "
            f"{len(got_ft)} fault-tree results within {worst:.3e} of the "
            f"JAX values (limit {PROB_RTOL}); {seconds:.3f} s; timings "
            f"{json.dumps(report['timings'])}")
        out["fixtures"][name] = {"seconds": seconds, "rel_err": worst}
    want = golden["sil_slice"]
    report, seconds = _run_cli(
        [SLICE_MODEL, "--device", device.type, "--probability", "--sil",
         "--time-step", str(want["time_step"]), "--skip-products"],
        "sil_slice")
    (ft,) = report["fault_trees"]
    worst = max([_rel(ft["sil"][k], want["sil"][k])
                 for k in ("pfd_avg", "pfh_avg")] +
                [_rel(v, v2) for (_t, v), (_t2, v2) in
                 zip(ft["time_curve"], want["time_curve"])])
    check([t for t, _ in ft["time_curve"]] ==
          [t for t, _ in want["time_curve"]], "SIL slice: time points")
    check(ft["sil"]["sil_level"] == want["sil"]["sil_level"] and
          ft["sil"]["pfd_fractions"] == want["sil"]["pfd_fractions"],
          f"SIL slice: {ft['sil']}")
    check(worst <= PROB_RTOL, f"SIL slice: rel err {worst:.3e}")
    log(f"[et] SIL slice through the CLI: {len(ft['time_curve'])} time "
        f"points, PFD avg {ft['sil']['pfd_avg']!r}, SIL "
        f"{ft['sil']['sil_level']}, within {worst:.3e} of the JAX values; "
        f"{seconds:.3f} s")
    out["sil_slice"] = {"seconds": seconds, "rel_err": worst}
    read_counts(record, "et-fixtures", ())

    # (b) The 64-sequence scale model with uncertainty on the forest path:
    # one stream launch per sequence root.
    scale_path = os.path.join(OUT_DIR, "et_scale64.xml")
    with open(scale_path, "w") as fh:
        fh.write(event_tree_scale_xml(deviates=True))
    argv = [scale_path, "--device", device.type, "--probability",
            "--uncertainty", "--num-trials", str(ET_TRIALS), "--seed",
            str(ET_SEED)]
    reset_counts()
    report, seconds = _run_cli(argv, "scale64")
    launches = read_counts(record, "et", ("stream",))
    tree, slots, tape, key, mission = _event_tree_inputs([scale_path])
    bdds = build_bdd_multi(tree, slots,
                           house_states=tree.house_state_vector())
    n_roots = sum(1 for b in bdds if b.resolved_root() > 1)
    n_modules = _fault_tree_modules([scale_path])
    seqs = report["sequences"]
    check(len(seqs) == 64 and n_roots == 64, f"{len(seqs)} sequences, "
                                             f"{n_roots} roots")
    # One launch per sequence root, beside one per module of the fault
    # trees' own uncertainty analyses.
    check(launches["stream"] == n_roots + n_modules,
          f"stream launched {launches['stream']} times for {n_roots} "
          f"sequence roots and {n_modules} fault-tree modules")
    check({s["uncertainty"]["method"] for s in seqs} == {"bdd-stream-f32"},
          "sequence uncertainty did not run the stream kernel")
    timings = report["timings"]
    check("propagation:IE" not in timings, "scale model left the forest")
    log(f"[et] scale64 through the CLI ({' '.join(argv[1:])}): "
        f"{seconds:.3f} s, launches {launches} ({n_roots} sequence roots, "
        f"{n_modules} fault-tree modules); host timings "
        f"{json.dumps(timings)}")
    # The kernel's tops of root 0 on the same samples: bit-equal to the
    # stream's plain version, their mean the reported one, and within
    # TOP_RTOL of the f64 level evaluation.
    samples, sample_ms = timed_ms(
        lambda: tape.sample(key, ET_TRIALS, mission, device))
    basic = torch.clamp(samples[:, :tree.n_basic], 0.0, 1.0)
    evaluators = [make_bdd_evaluator(b, device) for b in bdds]
    tops, eval_ms = timed_ms(lambda: [ev(basic) for ev in evaluators])
    enc = bdd_stream_encoding(bdds[0])
    plain, plain_ms = timed_ms(lambda: stream_forward_plain(
        enc, stage_basic(enc, basic, torch.float32),
        house_tensor(enc, np.zeros(0, np.float32), device))[0])
    check(torch.equal(tops[0], plain), "root 0: kernel differs from plain")
    mean = float(tops[0].double().cpu().numpy().mean())
    check(mean == seqs[0]["uncertainty"]["mean"],
          f"root 0: redrawn mean {mean!r} != reported "
          f"{seqs[0]['uncertainty']['mean']!r}")
    # The kernels alone, on inputs staged beforehand (still one host
    # dispatch per launch).
    staged = [(e, stage_basic(e, basic, torch.float32)) for e in
              (bdd_stream_encoding(b) for b in bdds)]
    kernel_ms = cuda_ms(lambda: [stream_propagate_staged(
        e, x, np.zeros(0, np.float32)) for e, x in staged], 3)
    level, level_ms = timed_ms(
        lambda: [bdd_probability(b, basic) for b in bdds])
    rel = max(float(((t.double() - ref).abs() / ref.abs()).max())
              for t, ref in zip(tops, level))
    check(rel <= TOP_RTOL, f"scale64: per-trial tops rel err {rel:.3e}")
    log(f"[et] scale64 root 0 ({bdds[0].n_nodes} BDD nodes): kernel tops "
        f"bit-equal to plain over {ET_TRIALS} trials, mean the reported "
        f"one; every root's tops within {rel:.3e} of the f64 level "
        f"evaluation (limit {TOP_RTOL}). Device: sampling {sample_ms:.3f} "
        f"ms; {len(bdds)} stream launches {eval_ms:.3f} ms through the "
        f"evaluators, {kernel_ms:.3f} ms on staged inputs; the f64 level "
        f"evaluation of all roots {level_ms:.3f} ms; plain stream of root "
        f"0 {plain_ms:.3f} ms")
    out["scale64"] = {"seconds": seconds, "launches": launches,
                      "host_timings": timings, "sample_ms": sample_ms,
                      "stream_ms": eval_ms, "stream_staged_ms": kernel_ms,
                      "level_f64_ms": level_ms,
                      "root0_plain_ms": plain_ms, "tops_rel_err": rel}
    del samples, basic, tops, plain, level, staged
    torch.cuda.empty_cache()

    # (c) The plant-width event tree with uncertainty: its forest exceeds
    # the 2,000,000-node limit, so it runs direct propagation, on CUDA one
    # multi-root stream launch per house row (it has none, so one row).
    argv = [*ET_PLANT, "--device", device.type, "--probability",
            "--uncertainty",
            "--num-trials", str(ET_TRIALS), "--seed", str(ET_SEED)]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    report, seconds = _run_cli(argv, "plant")
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(record, "et-plant", ("stream_roots",))
    tree, slots, tape, key, mission = _event_tree_inputs(ET_PLANT)
    n_modules = _fault_tree_modules(ET_PLANT)
    check(tree.n_house == 0 and launches["stream_roots"] == 1 and
          launches["stream"] == n_modules,
          f"plant tree: launches {launches}, {tree.n_house} house events, "
          f"{n_modules} fault-tree modules")
    timings = report["timings"]
    check("propagation:IE" in timings, "plant tree: no fallback")
    got = {s["sequence"]: s for s in report["sequences"]}
    check(set(got) == set(golden["sequences"]), "plant tree: sequences")
    worst = max(_rel(got[k]["probability"], v)
                for k, v in golden["sequences"].items())
    check(worst <= PROB_RTOL, f"plant tree: rel err {worst:.3e}")
    for s in got.values():
        unc = s["uncertainty"]
        check(unc["method"] == "direct-propagation" and
              unc["n_trials"] == ET_TRIALS and
              0.0 < unc["ci95"][0] <= unc["mean"] <= unc["ci95"][1] < 1.0,
              f"plant tree {s['sequence']}: {unc}")
    log(f"[et] plant event tree through the CLI ({' '.join(argv[1:])}): "
        f"{seconds:.3f} s, peak {peak / 2**30:.2f} GiB, launches "
        f"{launches} ({n_modules} fault-tree modules); 64 sequences within "
        f"{worst:.3e} of the golden values (limit {PROB_RTOL}); host "
        f"timings {json.dumps(timings)}")
    # Device time of its sampling, redone on the same inputs (the roots
    # kernel's is phase 11').
    samples, sample_ms = timed_ms(
        lambda: tape.sample(key, ET_TRIALS, mission, device))
    log(f"[et] plant tree sampling on the card: {tape.n_deviates} deviates "
        f"x {ET_TRIALS} trials {sample_ms:.3f} ms")
    out["plant"] = {"seconds": seconds, "peak_bytes": peak,
                    "launches": launches, "host_timings": timings,
                    "rel_err": worst, "sample_ms": sample_ms,
                    "n_nodes": tree.n_nodes}
    del samples
    torch.cuda.empty_cache()
    record["et"] = out


#: Phase 11' (path ``roots``): repetitions of the multi-root kernel and of
#: what it is timed against at ``ET_TRIALS`` trials.
ROOTS_REPS = 20
ROOTS_SLOW_REPS = 3
#: The kernel against the f64 gather engine: count gates round their DP
#: in another order (``tests/test_torch_sequence_roots.py``).
ROOTS_ATOL = 1e-12


def phase_roots(device, record: dict) -> None:
    """(11') The multi-root stream kernel on the plant event tree's 64
    sequence roots at ``ET_TRIALS`` float64 trials: bit-equal to its
    plain version, within ``ROOTS_ATOL`` of the gather engine on the same
    inputs, one launch; kernel, staging, plain version and gather engine
    timed beside the kernel's bound."""
    from canopy_tpu_torch.engine.propagate import propagate_probability
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_tree_stream, encode_stream, house_tensor,
        stream_roots_forward, stream_roots_forward_plain)
    tree, slots, tape, key, mission = _event_tree_inputs(ET_PLANT)
    enc = encode_stream(compile_tree_stream(tree, slots))
    house_row = tree.house_state_vector()
    house = house_tensor(enc, house_row, device, torch.float64)
    cols = torch.from_numpy(enc.staged_cols).to(device)
    samples = tape.sample(key, ET_TRIALS, mission, device)
    basic = torch.clamp(samples[:, :tree.n_basic], 0.0, 1.0)
    del samples

    def stage():
        return basic[:, cols].T.contiguous()
    staged = stage()
    reset_counts()
    got = stream_roots_forward(enc, staged, house)
    launches = read_counts(record, "roots", ("stream_roots",))
    check(launches["stream_roots"] == 1 and launches["stream"] == 0,
          f"roots: launches {launches}")
    check(got.dtype == torch.float64 and got.shape == (len(slots),
                                                        ET_TRIALS),
          f"roots: output {got.dtype} {tuple(got.shape)}")
    plain = stream_roots_forward_plain(enc, staged, house)
    check(torch.equal(got, plain), "roots: kernel != plain")
    del plain
    gather = propagate_probability(
        tree, basic, torch.as_tensor(house_row, device=device))[:, slots].T
    err = float((got - gather).abs().max())
    check(err <= ROOTS_ATOL, f"roots: kernel vs gather {err:.3e}")
    del gather
    torch.cuda.empty_cache()
    kernel_ms = cuda_ms(lambda: stream_roots_forward(enc, staged, house),
                        ROOTS_REPS)
    stage_ms = cuda_ms(stage, ROOTS_REPS)
    plain_ms = cuda_ms(lambda: stream_roots_forward_plain(enc, staged,
                                                          house),
                       ROOTS_SLOW_REPS)
    gather_ms = cuda_ms(lambda: propagate_probability(
        tree, basic, torch.as_tensor(house_row, device=device))[:, slots],
        ROOTS_SLOW_REPS)
    n_bytes = (enc.n_basic + len(slots)) * 8 * ET_TRIALS
    roof = bound(n_bytes, op_flops(enc) * ET_TRIALS, 8)
    log(f"[roots] plant event tree, {len(slots)} roots, {enc.n_ops} ops, "
        f"{len(enc.args)} arguments, {enc.pool_slots} pool slots, "
        f"{enc.n_basic} staged rows x {ET_TRIALS} f64 trials: kernel "
        f"{kernel_ms:.3f} ms (bound {roof['bound_ms']:.3f} ms, "
        f"{roof['bound_by']}; {100 * roof['bound_ms'] / kernel_ms:.2f} %), "
        f"staging {stage_ms:.3f} ms, plain {plain_ms:.3f} ms, gather "
        f"engine {gather_ms:.3f} ms; bit-equal to plain, {err:.3e} from "
        f"gather; launches {launches}")
    record["stream_roots"].update(
        max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms, **roof,
        stage_ms=stage_ms, gather_ms=gather_ms, gather_abs_err=err,
        n_ops=enc.n_ops, pool_slots=enc.pool_slots)
    del basic, staged, got
    torch.cuda.empty_cache()


#: Phase 12 (path ``project``): the project file's trials and seed, and
#: the checkpointed sweep's batches (stopped by an exception at
#: ``SWEEP_STOP``, then resumed).
PROJECT_TRIALS = 1 << 20
PROJECT_SEED = 7
SWEEP_BATCHES = 16
SWEEP_TRIALS = 65_536
SWEEP_STOP = 7
#: Phase 13 (path ``markov``): the chain sizes, the transient's batch and
#: time (hours; its truncation must fall in ``TRANSIENT_K``), and the
#: tolerances: the sparse stationary solve's ``tests/test_markov.py``
#: checks; the dense one against numpy's LU on the host (two pivoted
#: factorizations of an ill-conditioned balance matrix: 9.7e-11 apart
#: between torch's and numpy's on the CPU); the transient against scipy's
#: ``expm_multiply``; the blocked solve at its test's tolerance.
MARKOV_STATES = 10_000
MARKOV_DENSE_STATES = 2_000
MARKOV_COMPONENTS = 12
TRANSIENT_BATCH = 1_024
TRANSIENT_T = 24.0
TRANSIENT_K = (50, 500)
DENSE_PI_ATOL = 1e-9
TRANSIENT_ATOL = 1e-10
BLOCKED_TOL = 1e-9


def device_call(label: str, fn, elements: int, n_bytes: float, roof,
                out: dict, reps: int = 3):
    """``fn()`` timed on the card: CUDA-event milliseconds over ``reps``
    runs, its ``RooflineAccountant`` entry (``n_bytes``: each input read
    once, each output written once) and the peak device memory of one
    run; logged and kept in ``out[label]``.  Returns ``fn()``'s result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(fn, reps)
    entry = roof.record(label, elements, n_bytes / elements, ms / 1e3)
    out[label] = {"ms": ms, "bytes": n_bytes, "peak_bytes": peak,
                  "hbm_fraction": entry["hbm_fraction"]}
    log(f"[{label}] {ms:.3f} ms (CUDA events, {reps} runs), "
        f"{n_bytes / 1e6:.3f} MB at least, {entry['hbm_fraction']:.4f} "
        f"of {roof.bandwidth / 1e12:.2f} TB/s; peak {peak / 2**20:.1f} "
        f"MiB above the {base / 2**20:.1f} MiB held before")
    return result


def _fault_tree_products(report: dict) -> list:
    (ft,) = report["fault_trees"]
    return [(order, sorted(literals))
            for order, _prob, literals in ft["products"]]


def phase_project(device, record: dict) -> None:
    """(12) Project files, ``--version``, compiled-model I/O, the MEF
    writer and a checkpointed sweep, on the slice."""
    from canopy_tpu_torch.ops.prng import fold_in, prng_key
    import contextlib
    import io

    from canopy_tpu_torch.build_info import build_info
    from canopy_tpu_torch.cli import main as cli_main
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.checkpoint import (CheckpointedSweep,
                                                    SweepState)
    from canopy_tpu_torch.engine.propagate import make_propagator
    from canopy_tpu_torch.io.compiled_io import load_compiled, save_compiled
    from canopy_tpu_torch.io.mef_writer import model_to_mef_xml
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    from canopy_tpu_torch.utils.profiling import RooflineAccountant

    roof = RooflineAccountant()
    out: dict = {}
    wall0 = time.perf_counter()
    reset_counts()

    # (a) The project file through ``python -m canopy_tpu_torch --project``
    # (its default device, cuda), against the flag-driven CLI in-process.
    project = os.path.join(OUT_DIR, "slice_project.xml")
    project_report = os.path.join(OUT_DIR, "slice_project_report.json")
    with open(project, "w") as fh:
        fh.write(f"""<?xml version="1.0"?>
<canopy-project>
  <input-files><file>{SLICE_MODEL}</file></input-files>
  <options>
    <algorithm value="bdd"/>
    <analysis probability="true" importance="true" uncertainty="true"/>
    <limits num-trials="{PROJECT_TRIALS}" seed="{PROJECT_SEED}"/>
  </options>
  <output file="{project_report}"/>
</canopy-project>
""")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "canopy_tpu_torch", "--project", project],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    project_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"--project exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    with open(project_report) as fh:
        by_project = json.load(fh)
    flags = [SLICE_MODEL, "--device", device.type, "--bdd",
             "--probability", "--importance", "--uncertainty",
             "--num-trials", str(PROJECT_TRIALS), "--seed",
             str(PROJECT_SEED), "--validate"]
    by_flags, flags_s = _run_cli(flags, "project_flags")
    check(by_project["fault_trees"] == by_flags["fault_trees"] and
          by_project["settings"] == by_flags["settings"],
          "--project report differs from the flag-driven one")
    (ft,) = by_project["fault_trees"]
    check(ft["uncertainty"].get("method") == "bdd-stream-f32" and
          ft["uncertainty"]["n_trials"] == PROJECT_TRIALS,
          f"project uncertainty: method "
          f"{ft['uncertainty'].get('method')}, {ft['uncertainty']['n_trials']}"
          f" trials")
    log(f"[project] python -m canopy_tpu_torch --project (default device "
        f"cuda): {project_s:.3f} s in its own process, the flag-driven CLI "
        f"{flags_s:.3f} s in-process; probability {ft['probability']!r}, "
        f"{len(ft['importance'])} importance rows and the uncertainty "
        f"statistics (mean {ft['uncertainty']['mean']!r}) equal")
    out["project"] = {"project_s": project_s, "flags_s": flags_s}

    # The same flag-driven run (its input validated against the bundled
    # MEF grammar) writing the XML report, which validates against the
    # report grammar and carries the same probability.
    from canopy_tpu_torch.io.xml import Document, Validator
    from canopy_tpu_torch.schemas import report_schema_path
    xml_report = os.path.join(OUT_DIR, "slice_report.xml")
    t0 = time.perf_counter()
    check(cli_main([*flags, "-o", xml_report]) == 0, "--validate run "
                                                     "exited non-zero")
    validate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doc = Document(xml_report, Validator(report_schema_path()))
    report_s = time.perf_counter() - t0
    (analysis,) = doc.root.child("results").children("fault-tree-analysis")
    xml_p = analysis.child("probability").attribute("value", float)
    check(_rel(xml_p, ft["probability"]) <= PROB_RTOL,
          f"XML report probability {xml_p!r} vs {ft['probability']!r}")
    log(f"[project] --validate: the slice validated against mef.rng and "
        f"quantified in {validate_s:.3f} s; its XML report "
        f"({os.path.getsize(xml_report)} bytes) validated against "
        f"report.rng in {report_s:.3f} s, probability {xml_p!r}")
    out["validate"] = {"cli_s": validate_s, "report_validate_s": report_s}

    # (b) --version: git-derived where the tree is a git checkout.
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        try:
            cli_main(["--version"])
        except SystemExit as exc:
            check(exc.code == 0, f"--version exited {exc.code}")
    version = stdout.getvalue().strip()
    git = subprocess.run(["git", "rev-parse", "--show-toplevel"], cwd=ROOT,
                         capture_output=True, text=True).returncode == 0 \
        if shutil.which("git") else False
    info = build_info()
    check(version.startswith("canopy-tpu-torch ") and
          info["source"] == ("git" if git else "package") and
          (("+g" in version) == git), f"--version {version!r}, {info}")
    source = "git-derived" if git else \
        "not a git checkout: the package version"
    log(f"[project] --version: {version!r} ({source})")

    # (c) Compiled-model I/O: the loaded tree's tops bit-equal to the
    # tree's before saving, on the loaded tape's samples.
    tree = load_tree("torch_slice_plant")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    path = os.path.join(OUT_DIR, "slice_compiled.npz")
    save_compiled(path, tree, tape)
    loaded, loaded_tape = load_compiled(path)
    mission = Settings().mission_time()
    key = fold_in(prng_key(PROJECT_SEED), 0)
    samples = device_call(
        "sample-2^20", lambda: loaded_tape.sample(key, PROJECT_TRIALS,
                                                  mission, device),
        PROJECT_TRIALS, PROJECT_TRIALS * tree.n_basic * 8, roof, out)
    check(torch.equal(samples, tape.sample(key, PROJECT_TRIALS, mission,
                                           device)),
          "loaded tape samples differ")
    basic = torch.clamp(samples, 0.0, 1.0).float()
    del samples
    before = make_propagator(tree, device)(basic)
    propagate = make_propagator(loaded, device)
    check(propagate.engine == "stream", f"engine {propagate.engine}")
    after = device_call("loaded-tree-2^20", lambda: propagate(basic),
                        PROJECT_TRIALS,
                        PROJECT_TRIALS * (tree.n_basic + 1) * 4, roof, out)
    check(torch.equal(after, before), "loaded tree's tops differ")
    log(f"[project] save_compiled / load_compiled: {os.path.getsize(path)} "
        f"bytes; the loaded tree's {PROJECT_TRIALS} stream tops bit-equal "
        f"to the tree's before saving")
    del basic, before, after

    # (d) The MEF writer: the slice written, parsed again and quantified
    # through the CLI.
    model = Initializer([SLICE_MODEL], Settings()).model
    rewritten = os.path.join(OUT_DIR, "slice_rewritten.xml")
    with open(rewritten, "wb") as fh:
        fh.write(model_to_mef_xml(model))
    again, again_s = _run_cli([rewritten, "--device", device.type, "--bdd",
                               "--probability"], "project_rewritten")
    (ft2,) = again["fault_trees"]
    p_err = _rel(ft2["probability"], ft["probability"])
    check(p_err <= PROB_RTOL, f"rewritten model: rel err {p_err:.3e}")
    check(_fault_tree_products(again) == _fault_tree_products(by_flags),
          "rewritten model: products differ")
    log(f"[project] model_to_mef_xml: {os.path.getsize(rewritten)} bytes, "
        f"through the CLI {again_s:.3f} s: probability within {p_err:.3e} "
        f"(limit {PROB_RTOL}), the same {ft2['n_products']} products")

    # (e) A checkpointed sweep over the direct-propagation slice: each
    # batch samples the tape under fold_in(prng_key(seed), batch) and runs
    # the stream kernel; stopped at SWEEP_STOP, resumed, equal to
    # uninterrupted.
    class Stop(Exception):
        pass

    def batch_fn(stop_at=None):
        def fn(key, batch):
            if batch == stop_at:
                raise Stop(batch)
            s = tape.sample(key, SWEEP_TRIALS, mission, device)
            return propagate(torch.clamp(s, 0.0, 1.0).float()) \
                .double().cpu().numpy()
        return fn

    kw = dict(seed=PROJECT_SEED, n_batches=SWEEP_BATCHES,
              batch_trials=SWEEP_TRIALS)
    t0 = time.perf_counter()
    full = CheckpointedSweep(batch_fn(), **kw).run()
    sweep_s = time.perf_counter() - t0
    ckpt = os.path.join(OUT_DIR, "sweep_checkpoint.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    try:
        CheckpointedSweep(batch_fn(SWEEP_STOP), checkpoint_path=ckpt,
                          **kw).run()
        check(False, "the sweep did not stop")
    except Stop:
        pass
    check(SweepState.load(ckpt).completed_batches == SWEEP_STOP,
          "checkpoint after the stop")
    resumed = CheckpointedSweep(batch_fn(), checkpoint_path=ckpt,
                                **kw).run()
    for name in ("seed", "completed_batches", "completed_trials", "sum_",
                 "sum_sq", "reservoir_filled"):
        check(getattr(resumed, name) == getattr(full, name),
              f"resumed sweep: {name}")
    check(np.array_equal(resumed.reservoir, full.reservoir),
          "resumed sweep: reservoir")
    one = device_call(
        "sweep-batch", lambda: propagate(torch.clamp(tape.sample(
            fold_in(prng_key(PROJECT_SEED), 0), SWEEP_TRIALS, mission,
            device), 0.0, 1.0).float()), SWEEP_TRIALS,
        SWEEP_TRIALS * (tree.n_basic + 1) * 4, roof, out)
    del one
    launches = read_counts(record, "project", ("stream", "stream_log",
                                                "adjoint"))
    log(f"[project] CheckpointedSweep: {SWEEP_BATCHES} batches x "
        f"{SWEEP_TRIALS} trials in {sweep_s:.3f} s uninterrupted; stopped "
        f"at batch {SWEEP_STOP}, resumed from its checkpoint: the final "
        f"state bit-equal (mean {full.mean!r}, std {full.std!r}); path "
        f"launches {launches}")
    out["sweep_s"] = sweep_s
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - wall0
    log(f"[project] phase wall time {out['wall_s']:.3f} s")
    record["project"] = out


def phase_markov(device, record: dict) -> None:
    """(13) Markov submodels in f64 on the card."""
    from scipy.sparse import csr_matrix, diags
    from scipy.sparse.linalg import expm_multiply, spsolve_triangular

    from canopy_tpu_torch.ops import markov
    from canopy_tpu_torch.utils.markov_models import (birth_death_csr,
                                                      random_lower_csr,
                                                      repairable_components)
    from canopy_tpu_torch.utils.profiling import RooflineAccountant

    roof = RooflineAccountant()
    out: dict = {}
    wall0 = time.perf_counter()
    rng = np.random.default_rng(SLICE_SEED)
    reset_counts()

    # (a) The stationary distribution of the 10,000-state CSR chain: the
    # host factorization, then the two blocked substitutions on the card.
    sp = birth_death_csr(MARKOV_STATES, seed=3)
    factors = []
    sparse_lu = markov.sparse_lu

    def keep_factors(*args, **kwargs):
        factors.append(sparse_lu(*args, **kwargs))
        return factors[-1]

    markov.sparse_lu = keep_factors
    try:
        t0 = time.perf_counter()
        pi = markov.markov_stationary((sp.indptr, sp.indices, sp.data),
                                      method="sparse", device=device)
        torch.cuda.synchronize()
        stationary_s = time.perf_counter() - t0
    finally:
        markov.sparse_lu = sparse_lu
    check(pi.device.type == "cuda", f"pi on {pi.device}")
    pi_h = pi.cpu().numpy()
    resid = float(np.abs(pi_h @ sp).max())
    check(abs(pi_h.sum() - 1.0) < 1e-8 and resid < 1e-10 and
          bool((pi_h > 0).all()),
          f"stationary: sum {pi_h.sum()!r}, |pi Q| {resid:.3e}")
    (lu,) = factors
    e_last = torch.zeros(MARKOV_STATES, dtype=torch.float64, device=device)
    e_last[-1] = 1.0
    device_call("lu-solve-10k", lambda: lu.solve(e_last), MARKOV_STATES,
                sum(t.numel() * t.element_size() for bt in (lu.L, lu.U)
                    for t in (bt.dense, bt.off_idx, bt.off_val))
                + 2 * MARKOV_STATES * 8, roof, out)
    log(f"[markov] markov_stationary, {MARKOV_STATES} states (CSR, "
        f"{sp.nnz} entries): {stationary_s:.3f} s, most of it the host "
        f"factorization ({lu.nnz_factors} factor entries, "
        f"{lu.L.n_blocks} blocks); sum - 1 = {pi_h.sum() - 1.0:.3e}, "
        f"max |pi Q| {resid:.3e} (limit 1e-10), every pi > 0")
    out["stationary_s"] = stationary_s

    # (b) The dense path on the first MARKOV_DENSE_STATES states against
    # numpy on the host.
    n = MARKOV_DENSE_STATES
    q = sp[:n, :n].toarray()
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    q_t = torch.from_numpy(q).to(device)
    pi_d = device_call("dense-stationary-2k",
                       lambda: markov.markov_stationary(q_t), n,
                       (n * n + 2 * n) * 8, roof, out)
    a = np.concatenate([q[:, :-1], np.ones((n, 1))], axis=1)
    e = np.zeros(n)
    e[-1] = 1.0
    ref = np.linalg.solve(a.T, e)
    diff = float(np.abs(pi_d.cpu().numpy() - ref).max())
    check(diff <= DENSE_PI_ATOL, f"dense stationary: {diff:.3e} from numpy")
    log(f"[markov] dense markov_stationary, {n} states: within {diff:.3e} "
        f"of numpy's solve (limit {DENSE_PI_ATOL})")

    # (c) The transient of MARKOV_COMPONENTS repairable components (a
    # 2^12-state Kronecker-sum generator), batched over TRANSIENT_BATCH
    # initial distributions.
    Q = repairable_components(MARKOV_COMPONENTS, seed=5)
    S = len(Q)
    lam = float(np.max(-np.diag(Q))) * TRANSIENT_T * 1.0000001
    K = markov._poisson_terms(lam, 1e-12)
    check(TRANSIENT_K[0] <= K <= TRANSIENT_K[1], f"truncation K = {K}")
    p0 = rng.random((TRANSIENT_BATCH, S))
    p0 /= p0.sum(axis=1, keepdims=True)
    Q_t, p0_t = torch.from_numpy(Q).to(device), torch.from_numpy(p0).to(device)
    pt = device_call(
        "transient-4096x1024",
        lambda: markov.markov_transient(Q_t, p0_t, TRANSIENT_T),
        TRANSIENT_BATCH * S, (S * S + 2 * TRANSIENT_BATCH * S) * 8, roof,
        out)
    rows = [0, 1, TRANSIENT_BATCH // 2, TRANSIENT_BATCH - 1]
    want = expm_multiply(csr_matrix(Q.T) * TRANSIENT_T, p0[rows].T).T
    diff = float(np.abs(pt[rows].cpu().numpy() - want).max())
    check(diff <= TRANSIENT_ATOL, f"transient: {diff:.3e} from scipy")
    flops = 2.0 * TRANSIENT_BATCH * S * S * (K - 1)
    log(f"[markov] markov_transient, {S} states x {TRANSIENT_BATCH} "
        f"initial distributions at t = {TRANSIENT_T} h: K = {K}, rows "
        f"{rows} within {diff:.3e} of scipy's expm_multiply (limit "
        f"{TRANSIENT_ATOL}); {flops / 1e12:.3f} TFLOP of f64 matmuls, "
        f"{flops / out['transient-4096x1024']['ms'] / 1e9:.1f} TFLOP/s")
    out["transient_K"] = K
    del Q_t, p0_t, pt

    # (d) BlockedTriangular.solve on the 10,000-row lower chain system.
    indptr, indices, data, diag = random_lower_csr(MARKOV_STATES,
                                                   3.0 / MARKOV_STATES,
                                                   seed=0, chain=True)
    bt = markov.compile_blocked_triangular(indptr, indices, data, diag,
                                           lower=True, device=device)
    b = np.random.default_rng(3).uniform(-1, 1, MARKOV_STATES)
    b_t = torch.from_numpy(b).to(device)
    x = device_call("blocked-solve-10k", lambda: bt.solve(b_t),
                    MARKOV_STATES,
                    sum(t.numel() * t.element_size()
                        for t in (bt.dense, bt.off_idx, bt.off_val))
                    + 2 * MARKOV_STATES * 8, roof, out)
    full = (csr_matrix((data, indices, indptr),
                       shape=(MARKOV_STATES,) * 2) + diags(diag)).tocsr()
    want = spsolve_triangular(full, b, lower=True)
    err = float(np.max(np.abs(x.cpu().numpy() - want)
                       / (BLOCKED_TOL + BLOCKED_TOL * np.abs(want))))
    check(err <= 1.0, f"blocked solve: {err:.3e} of its tolerance")
    log(f"[markov] BlockedTriangular.solve, {MARKOV_STATES} rows "
        f"({bt.n_blocks} blocks of {bt.block}): {err:.3e} of its "
        f"tolerance (rtol = atol = {BLOCKED_TOL}) against scipy's "
        f"spsolve_triangular")
    # Torch operations only: no kernel of csrc/ runs on this path.
    out["launches"] = read_counts(record, "markov", ())
    out["wall_s"] = time.perf_counter() - wall0
    log(f"[markov] phase wall time {out['wall_s']:.3f} s")
    record["markov"] = out


#: Phase 14 (path ``parallel``): trials of the stream step on one rank
#: (14a) and per rank (14b), of the grad, replay and tree steps, and of
#: the cut-set quantifier; the plant tree's trials go through in slabs.
PARALLEL_STREAM_TRIALS = 1 << 20
PARALLEL_RANK_TRIALS = 1 << 19
PARALLEL_GRAD_TRIALS = 65_536
PARALLEL_REPLAY_TRIALS = 65_536
PARALLEL_TREE_TRIALS = 65_536
PARALLEL_TREE_SLAB = 8_192
PARALLEL_CUTSET_TRIALS = 65_536
PARALLEL_SEED = 20271
PARALLEL_RANKS = 2
#: Seconds a collective may wait before its rank fails.
PARALLEL_TIMEOUT_S = 300
#: The kernels the parallel path runs inside its sharded steps.
PARALLEL_KERNELS = ("stream", "stream_log", "adjoint", "replay")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_programs() -> dict:
    """The host-built inputs of phase 14, built once and handed to every
    rank: the slice's big BDD module program, the 65k replay tree and its
    program, the reordered plant tree, the slice tree's minimal cut sets
    as a matrix."""
    from canopy_tpu_torch.compiler.bdd import build_bdd
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    from canopy_tpu_torch.compiler.reorder import (locality_reorder,
                                                   random_shuffle)
    from canopy_tpu_torch.compiler.zbdd import bdd_minimal_cut_sets
    from canopy_tpu_torch.engine.cutset_quantify import build_cutset_matrix
    from canopy_tpu_torch.ops.stream_kernel import (bdd_stream_encoding,
                                                    compile_replay_stream,
                                                    encode_replay)
    from canopy_tpu_torch.utils.synthetic import (synthetic_compiled_tree,
                                                  synthetic_hierarchical_tree)
    times = {}
    t0 = time.perf_counter()
    slice_tree = load_tree("torch_slice_plant")
    chain = build_modular_bdd(slice_tree).chain
    module = bdd_stream_encoding(max((b for b, _ in chain),
                                     key=lambda b: b.n_nodes))
    products, _truncated = bdd_minimal_cut_sets(
        build_bdd(slice_tree, house_states=slice_tree.house_state_vector()),
        limit_order=20, with_truncation=True)
    matrix = build_cutset_matrix(products, slice_tree.n_basic)
    times["slice_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    replay_tree = synthetic_compiled_tree(**REPLAY_TREE)
    replay = encode_replay(compile_replay_stream(replay_tree))
    times["replay_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.path.join(FIXTURES, "golden.json")) as fh:
        gold = json.load(fh)["plant_hier_9363"]
    plant = synthetic_hierarchical_tree(**gold["generator"])
    plant = locality_reorder(random_shuffle(plant, seed=1).tree,
                             hot_first=True).tree
    times["plant_s"] = time.perf_counter() - t0
    return {"module": module, "replay_tree": replay_tree, "replay": replay,
            "plant": plant, "matrix": matrix, "build": times}


def _host_only(progs: dict) -> dict:
    """``progs`` with the encodings' caches emptied (they hold device
    tables; a rank rebuilds what it needs on its own device)."""
    import copy
    out = dict(progs)
    for key in ("module", "replay"):
        out[key] = copy.copy(progs[key])
        out[key]._cache = {}
    return out


def _uniform(shape, seed: int, device, lo=0.0, hi=1.0,
             dtype=torch.float32) -> torch.Tensor:
    """The same draw on every rank: a seeded generator on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device,
                      dtype=dtype).mul_(hi - lo).add_(lo)


def _collective_bytes(fn):
    """``(fn(), bytes each collective moved during the call)``."""
    from canopy_tpu_torch.parallel.distributed import COLLECTIVE_BYTES
    before = dict(COLLECTIVE_BYTES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in
                 COLLECTIVE_BYTES.items() if v != before.get(k, 0)}


def parallel_steps(progs: dict, device, stream_trials: int,
                   label: str) -> dict:
    """Every parallel entry point at full width on this rank, each held to
    the unsharded single-device path on the same trials (rank 0 runs the
    unsharded path on the gathered batch).  Returns what was measured."""
    import torch.distributed as dist
    from canopy_tpu_torch.engine.cutset_quantify import (
        mcub, product_probabilities, rare_event)
    from canopy_tpu_torch.engine.propagate import top_event_probability
    from canopy_tpu_torch.ops.stream_kernel import (replay_propagate,
                                                    stream_propagate)
    from canopy_tpu_torch.parallel.mesh import make_mesh
    from canopy_tpu_torch.parallel.partition import \
        make_partitioned_propagator
    from canopy_tpu_torch.parallel.pipeline import (make_pipe_mesh,
                                                    make_pipeline_propagator)
    from canopy_tpu_torch.parallel.quantify import (
        gather_trials, shard_trials, sharded_cutset_quantifier,
        sharded_replay_step, sharded_stream_grad_step, sharded_stream_step)

    world, rank = dist.get_world_size(), dist.get_rank()
    lead = rank == 0
    mesh = make_mesh(device)                            # trials over all
    tp_mesh = make_mesh(device, model_parallelism=world)    # rows over all
    pipe_mesh = make_pipe_mesh(device, pipe=world)
    out: dict = {"rank": rank, "world": world, "steps": {}}
    steps = out["steps"]
    enc = progs["module"]
    n_cols = int(enc.staged_cols.max()) + 1
    none = np.zeros(0, np.float32)

    def record(name, local_ms, whole_ms, moved, **extra):
        steps[name] = {"ms": local_ms, "unsharded_ms": whole_ms,
                       "collective_bytes": moved, **extra}
        whole = "rank 0 times" if whole_ms is None else f"{whole_ms:.3f} ms"
        log(f"[parallel {label}] rank {rank}/{world} {name}: {local_ms:.3f} "
            f"ms sharded, unsharded {whole}; collectives {moved}; {extra}")

    # The stream step on the slice's BDD module (the step kernel), on
    # PRA-scale probabilities (phase 3's draw).
    x = _uniform((stream_trials * world, n_cols), PARALLEL_SEED, device, 0.0,
                 0.02)
    local = shard_trials(mesh, x)
    step = sharded_stream_step(enc, mesh, none)
    tops, moved = _collective_bytes(lambda: gather_trials(mesh, step(local)))
    ms = cuda_ms(lambda: step(local), 3)
    whole_ms = None
    if lead:
        whole = stream_propagate(enc, x, none)
        check(torch.equal(tops, whole), f"{label}: sharded stream tops "
                                        "differ from the unsharded kernel's")
        whole_ms = cuda_ms(lambda: stream_propagate(enc, x, none), 3)
    record("stream", ms, whole_ms, moved, trials=int(local.shape[0]),
           ops=enc.n_ops, **({"bit_equal": True} if lead else {}))
    del x, local, tops

    # The grad step on the same program (level-parallel logged forward,
    # gather-form backward).
    x = _uniform((PARALLEL_GRAD_TRIALS, n_cols), PARALLEL_SEED + 1, device,
                 0.0, 0.02)
    local = shard_trials(mesh, x)
    grad_step = sharded_stream_grad_step(enc, mesh, none)
    (tops_l, grad_l), _ = _collective_bytes(lambda: grad_step(local))
    tops_g, grad_g = gather_trials(mesh, tops_l), gather_trials(mesh, grad_l)
    ms = cuda_ms(lambda: grad_step(local), 3)
    whole_ms, extra = None, {}
    if lead:
        w_tops, w_grad = grad_step(x)
        same = torch.equal(tops_g, w_tops) and torch.equal(grad_g, w_grad)
        diff = float((grad_g - w_grad).abs().max())
        g64 = sharded_stream_grad_step(enc, mesh, none,
                                       torch.float64)(x)[1]
        err = _grad_error(grad_g.T, g64.T)
        check(err <= GRAD_RTOL["f32"], f"{label}: grad vs f64 {err:.3e}")
        check(same, f"{label}: sharded grad differs from the unsharded "
                    f"step (max abs {diff:.3e})")
        whole_ms = cuda_ms(lambda: grad_step(x), 3)
        extra = {"bit_equal": same, "grad_vs_f64": err}
    record("stream_grad", ms, whole_ms, {}, trials=int(local.shape[0]),
           **extra)
    del x, local

    # The replay step on the 65k tree.
    rtree, renc = progs["replay_tree"], progs["replay"]
    rhouse = rtree.house_state_vector()
    x = _uniform((PARALLEL_REPLAY_TRIALS, rtree.n_basic), PARALLEL_SEED + 2,
                 device, 0.0, 0.05)
    local = shard_trials(mesh, x)
    rstep = sharded_replay_step(renc, mesh, rhouse)
    tops = gather_trials(mesh, rstep(local))
    ms = cuda_ms(lambda: rstep(local), 3)
    whole_ms = None
    if lead:
        check(torch.equal(tops, replay_propagate(renc, x, rhouse)),
              f"{label}: sharded replay tops differ from the unsharded "
              "kernel's")
        whole_ms = cuda_ms(lambda: replay_propagate(renc, x, rhouse), 3)
    record("replay", ms, whole_ms, {}, trials=int(local.shape[0]),
           **({"bit_equal": True} if lead else {}))
    del x, local, tops

    # Partition (gate rows over every rank) and pipeline (levels over
    # every rank) on the reordered plant tree, slab by slab.
    plant = progs["plant"]
    part = make_partitioned_propagator(plant, tp_mesh)
    pipe = make_pipeline_propagator(plant, pipe_mesh)
    house = torch.zeros(plant.n_house, device=device)
    moved_part = moved_pipe = None
    part_ms = pipe_ms = gather_ms = 0.0
    for s in range(PARALLEL_TREE_TRIALS // PARALLEL_TREE_SLAB):
        x = _uniform((PARALLEL_TREE_SLAB, plant.n_basic),
                     PARALLEL_SEED + 10 + s, device, 1e-4, 5e-3)
        with torch.no_grad():
            got, m1 = _collective_bytes(lambda: part(x, house))
            got_pipe, m2 = _collective_bytes(lambda: pipe(x, house))
            want = top_event_probability(plant, x, house)
            check(torch.equal(got, want), f"{label}: partition tops differ "
                                          "from the gather engine's")
            check(torch.equal(got_pipe, want), f"{label}: pipeline tops "
                                               "differ from the gather "
                                               "engine's")
            if s == 0:
                moved_part, moved_pipe = m1, m2
                part_ms = cuda_ms(lambda: part(x, house), 2)
                pipe_ms = cuda_ms(lambda: pipe(x, house), 2)
                gather_ms = cuda_ms(
                    lambda: top_event_probability(plant, x, house), 2)
        del x, got, got_pipe, want
    record("partition", part_ms, gather_ms, moved_part,
           slab=PARALLEL_TREE_SLAB, trials=PARALLEL_TREE_TRIALS,
           bit_equal=True)
    record("pipeline", pipe_ms, gather_ms, moved_pipe,
           slab=PARALLEL_TREE_SLAB, trials=PARALLEL_TREE_TRIALS,
           bit_equal=True)

    # The cut-set quantifier on the slice's minimal cut sets (f64).
    matrix = progs["matrix"]
    x = _uniform((PARALLEL_CUTSET_TRIALS, matrix.n_basic), PARALLEL_SEED + 3,
                 device, 0.0, 0.1, torch.float64)
    quantify = sharded_cutset_quantifier(matrix, tp_mesh)
    local = shard_trials(tp_mesh, x, ("data",))
    (re_l, mcub_l), moved = _collective_bytes(lambda: quantify(local))
    re_g = gather_trials(tp_mesh, re_l, ("data",))
    mcub_g = gather_trials(tp_mesh, mcub_l, ("data",))
    ms = cuda_ms(lambda: quantify(local), 3)
    q = product_probabilities(matrix, x)
    err = max(float(((re_g - rare_event(q)).abs() / rare_event(q)).max()),
              float(((mcub_g - mcub(q)).abs() / mcub(q)).max()))
    check(err <= PROB_RTOL, f"{label}: cut sets rel err {err:.3e}")
    whole_ms = cuda_ms(lambda: (rare_event(product_probabilities(matrix, x)),
                                mcub(product_probabilities(matrix, x))), 3)
    record("cutset", ms, whole_ms, moved, products=matrix.n_products,
           rel_err=err)
    return out


def _parallel_rank(rank: int, port: int, progs: dict,
                   device_type: str = "cuda") -> None:
    """One rank of phase 14b (spawned; gloo between ranks, compute on the
    one card); writes what it measured to ``parallel_rank<r>.json``."""
    import torch.distributed as dist
    from canopy_tpu_torch.parallel.distributed import (HOST_ROUTED,
                                                       initialize)
    from canopy_tpu_torch.parallel.dryrun import dryrun_multichip
    from canopy_tpu_torch.parallel.mesh import make_mesh
    from canopy_tpu_torch.utils.profiling import counters
    device = torch.device(device_type)
    t0 = time.perf_counter()
    initialize(f"tcp://localhost:{port}", PARALLEL_RANKS, rank,
               device=device, backend="gloo", timeout=PARALLEL_TIMEOUT_S)
    mesh = make_mesh(device)
    torch.cuda.synchronize()
    start = counters()
    dry = dryrun_multichip(mesh, device)
    run = parallel_steps(progs, device, PARALLEL_RANK_TRIALS, "14b")
    torch.cuda.synchronize()
    run.update(dryrun=dry, launches=launches_since(start),
               host_routed=dict(HOST_ROUTED),
               jax=sorted(m for m in sys.modules if m == "jax" or
                          m.startswith(("jax.", "canopy_tpu."))),
               wall_s=time.perf_counter() - t0)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(OUT_DIR, f"parallel_rank{rank}.json"), "w") as fh:
        json.dump(run, fh, default=str)


def phase_parallel(device, record: dict) -> None:
    """(14) The path ``parallel``: (a) one NCCL rank on the card, every
    entry point at full width and ``dryrun_multichip``; (b) two ranks
    sharing the card over gloo, each running ``dryrun_multichip`` and the
    same steps."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from canopy_tpu_torch.parallel.distributed import (COLLECTIVE_BYTES,
                                                       HOST_ROUTED,
                                                       initialize)
    from canopy_tpu_torch.parallel.dryrun import dryrun_multichip
    from canopy_tpu_torch.parallel.mesh import make_mesh

    wall0 = time.perf_counter()
    progs = parallel_programs()
    log(f"[parallel] host builds {progs['build']} (slice module "
        f"{progs['module'].n_ops} ops; replay tree {progs['replay'].n_ops} "
        f"ops, {progs['replay'].n_evicted} evictions; plant tree "
        f"{progs['plant'].n_gates} gates; {progs['matrix'].n_products} "
        f"slice cut sets)")
    out: dict = {"build": progs["build"]}

    # (a) One NCCL rank.
    t0 = time.perf_counter()
    initialize(f"tcp://localhost:{free_port()}", 1, 0, device=device,
               timeout=PARALLEL_TIMEOUT_S)
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    dry = dryrun_multichip(make_mesh(device), device)
    log(f"[parallel 14a] dryrun_multichip on one NCCL rank: {dry}")
    reset_counts()
    out["a"] = parallel_steps(progs, device, PARALLEL_STREAM_TRIALS, "14a")
    launches = read_counts(record, "parallel", PARALLEL_KERNELS)
    out["a"].update(dryrun=dry, launches=launches,
                    collective_bytes=dict(COLLECTIVE_BYTES),
                    wall_s=time.perf_counter() - t0)
    dist.destroy_process_group()
    log(f"[parallel 14a] launches {launches}; wall "
        f"{out['a']['wall_s']:.3f} s")
    torch.cuda.empty_cache()

    # (b) Two ranks on the one card over gloo.
    t0 = time.perf_counter()
    mp.spawn(_parallel_rank, args=(free_port(), _host_only(progs),
                                   device.type),
             nprocs=PARALLEL_RANKS, join=True)
    ranks = []
    for rank in range(PARALLEL_RANKS):
        with open(os.path.join(OUT_DIR, f"parallel_rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    for run in ranks:
        check(run["jax"] == [], f"rank {run['rank']} imported {run['jax']}")
        for name in PARALLEL_KERNELS:
            check(run["launches"][name] > 0,
                  f"14b rank {run['rank']}: kernel {name} never launched")
        log(f"[parallel 14b] rank {run['rank']}: dryrun {run['dryrun']}; "
            f"launches {run['launches']}; collectives through the host "
            f"{run['host_routed']}; wall {run['wall_s']:.3f} s")
    out["b"] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
    out["host_routed"] = {"parent": dict(HOST_ROUTED),
                          "ranks": [r["host_routed"] for r in ranks]}
    out["wall_s"] = time.perf_counter() - wall0
    log(f"[parallel] phase wall time {out['wall_s']:.3f} s (14b "
        f"{out['b']['wall_s']:.3f} s with the spawn)")
    record["parallel"] = out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import canopy_tpu_torch  # noqa: F401  (raises outside the repository)
    check("jax" not in sys.modules, "the port imported jax")
    os.makedirs(OUT_DIR, exist_ok=True)
    device = torch.device("cuda")
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; g++ "
        f"{shutil.which('g++')}")
    record = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": rep} for name, (src, rep) in
              KERNELS.items()}
    phase_build(record)
    phase_kernels(device, record)
    phase_fused(device, record)
    phase_dispatch(device, record)
    phase_wide_count(device, record)
    phase_slice(device, record)
    phase_prng(device, record)
    phase_pdag(device, record)
    phase_replay(device, record)
    phase_mc(device, record)
    phase_spill(device, record)
    phase_block(device, record)
    phase_et(device, record)
    phase_roots(device, record)
    phase_project(device, record)
    phase_markov(device, record)
    phase_parallel(device, record)
    check("jax" not in sys.modules, "the port imported jax")
    for name in KERNELS:
        record[name]["launches"] = record["paths"][PATH_OF[name]][name]
    kernels = [{k: record[name][k] for k in
                ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")} for name in KERNELS]
    with open(os.path.join(OUT_DIR, "chip_smoke_record.json"), "w") as fh:
        json.dump({"card": smi, **record}, fh, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
