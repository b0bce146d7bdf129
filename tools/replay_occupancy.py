"""The ring kernel against the stream kernel, by pool size: replay, or
with ``--spill`` the spill engine.

The replay and spill kernels (``csrc/replay_ops.cuh``'s ring kernel) keep
their pool, any resident tier and the prefetch ring in shared memory, so
the slots they are given set how many trials an SM holds
(``stream_kernel.replay_plan``: block width and ring depth); fewer slots
hold more trials but evict more values to device memory.  This script
runs ``bench.py``'s 65,536-gate replay tree
(``synthetic_compiled_tree(n_basic=8192, n_gates=65536, fanin=4,
n_levels=14, seed=0)``) on uniform(0, 0.05) float32 inputs drawn by numpy
(seed 20263, as ``chip_smoke.py`` phases 8 and 9) under several sizings of
the replay schedule (``compile_replay_stream``) or of the spill schedule
(``compile_spill_stream``), checks each against the stream kernel bit for
bit, and times both with CUDA events.

Run from the repository root on a machine with one CUDA card:

    python3 tools/replay_occupancy.py [--spill] [--trials 65536] [--reps 3]

It prints one line per sizing and, last, one JSON object with every
number and the card's ``nvidia-smi`` name and power limit; it exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (REPLAY_SEED, REPLAY_TREE, cuda_ms,  # noqa: E402
                        nvidia_smi, replay_inputs)

#: (pool slots, resident tiles requested) of each replay sizing: the
#: default, then pools without a resident tier from the most one warp's
#: block holds down to 14, and one with a 256-slot resident tier.
SIZINGS = [(None, None), (1743, 0), (454, 0), (227, 0), (113, 0), (56, 0),
           (28, 0), (14, 0), (198, 256)]
#: Pool slots of each spill sizing: the default, then from the most one
#: warp's block holds down to 14.
SPILL_SIZINGS = [None, 1743, 454, 227, 113, 56, 28, 14]


def replay_rows(tree, args, p, want) -> list:
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_replay_stream, encode_replay, replay_forward, replay_plan,
        stage_replay)
    rows = []
    for pool, resident in SIZINGS:
        kw = {} if pool is None else dict(pool_slots=pool,
                                          resident_tiles=resident)
        t0 = time.perf_counter()
        prog = compile_replay_stream(tree, **kw)
        enc = encode_replay(prog)
        build_s = time.perf_counter() - t0
        staged = stage_replay(enc, p)
        got, _ = replay_forward(enc, staged, [])
        check = torch.equal(got, want)
        ms = cuda_ms(lambda: replay_forward(enc, staged, []), args.reps)
        plan = replay_plan(enc, torch.float32, args.trials)
        rows.append(dict(pool=prog.pool_slots, resident=prog.res_tiles,
                         block_trials=plan.width, ring_depth=plan.depth,
                         evictions=prog.n_evicted, inter=prog.n_inter,
                         intra=prog.n_intra, slab=prog.n_slab_reads,
                         stream_rows=prog.brs_len_pad, ms=ms,
                         bit_equal_to_stream=check, build_s=build_s))
        print(json.dumps(rows[-1]), flush=True)
        del staged, got
        torch.cuda.empty_cache()
        if not check:
            break
    return rows


def spill_rows(tree, args, p, want) -> list:
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_spill_stream, encode_spill, replay_plan, replay_ring_stream,
        spill_forward, stage_basic)
    rows = []
    for pool in SPILL_SIZINGS:
        kw = {} if pool is None else dict(pool_slots=pool)
        t0 = time.perf_counter()
        enc = encode_spill(compile_spill_stream(tree, **kw))
        build_s = time.perf_counter() - t0
        staged = stage_basic(enc, p)
        got = spill_forward(enc, staged, [])
        check = torch.equal(got, want)
        ms = cuda_ms(lambda: spill_forward(enc, staged, []), args.reps)
        plan = replay_plan(enc, torch.float32, args.trials)
        ring = replay_ring_stream(enc, plan.depth)
        rows.append(dict(pool=enc.pool_slots, block_trials=plan.width,
                         ring_depth=plan.depth, ops=enc.n_ops,
                         ring_pads=ring.n_pads, **enc.counts, ms=ms,
                         bit_equal_to_stream=check, build_s=build_s))
        print(json.dumps(rows[-1]), flush=True)
        del staged, got
        torch.cuda.empty_cache()
        if not check:
            break
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spill", action="store_true",
                        help="sweep the spill pool instead of replay's")
    parser.add_argument("--trials", type=int, default=65_536)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("replay_occupancy: needs a CUDA device", file=sys.stderr)
        return 1
    from canopy_tpu_torch.ops.stream_kernel import (stage_basic,
                                                    stream_forward,
                                                    tree_stream_encoding)
    from canopy_tpu_torch.utils.synthetic import synthetic_compiled_tree
    device = torch.device("cuda")
    card = nvidia_smi()
    tree = synthetic_compiled_tree(**REPLAY_TREE)
    p = replay_inputs(args.trials, tree.n_basic, REPLAY_SEED, device)
    senc = tree_stream_encoding(tree)
    sstaged = stage_basic(senc, p)
    want, _ = stream_forward(senc, sstaged, [])
    stream_ms = cuda_ms(lambda: stream_forward(senc, sstaged, []), args.reps)
    print(f"stream: {senc.n_ops} ops, pool {senc.pool_slots} rows in device "
          f"memory: {stream_ms:.3f} ms", flush=True)
    del sstaged
    kind = "spill" if args.spill else "replay"
    rows = (spill_rows if args.spill else replay_rows)(tree, args, p, want)
    print(json.dumps({"card": card, "trials": args.trials,
                      "stream_ms": stream_ms, kind: rows}))
    if not all(r["bit_equal_to_stream"] for r in rows):
        print(f"replay_occupancy: {kind} and stream tops differ",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
