"""The replay kernel against the stream kernel, by replay pool size.

The replay kernel keeps its pool, resident tier and prefetch ring in
shared memory, so the slots it is given set how many trials an SM holds
(``stream_kernel.replay_plan``: block width and ring depth); fewer slots
hold more trials but evict more values to the device-memory log.  This
script runs ``bench.py``'s 65,536-gate replay tree
(``synthetic_compiled_tree(n_basic=8192, n_gates=65536, fanin=4,
n_levels=14, seed=0)``) on uniform(0, 0.05) float32 inputs drawn by numpy
(seed 20263, as ``chip_smoke.py`` phase 8) under several replay sizings,
checks each against the stream kernel bit for bit, and times both with
CUDA events.

Run from the repository root on a machine with one CUDA card:

    python3 tools/replay_occupancy.py [--trials 65536] [--reps 3]

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

#: (pool slots, resident tiles requested) of each sizing: the default,
#: then pools without a resident tier from the most one warp's block
#: holds down to 14, and one with a 256-slot resident tier.
SIZINGS = [(None, None), (1743, 0), (454, 0), (227, 0), (113, 0), (56, 0),
           (28, 0), (14, 0), (198, 256)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=65_536)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("replay_occupancy: needs a CUDA device", file=sys.stderr)
        return 1
    from canopy_tpu_torch.ops.stream_kernel import (
        compile_replay_stream, encode_replay, replay_forward, replay_plan,
        stage_basic, stage_replay, stream_forward, tree_stream_encoding)
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
        row = dict(pool=prog.pool_slots, resident=prog.res_tiles,
                   block_trials=plan.width, ring_depth=plan.depth,
                   evictions=prog.n_evicted, inter=prog.n_inter,
                   intra=prog.n_intra, slab=prog.n_slab_reads,
                   stream_rows=prog.brs_len_pad, ms=ms,
                   bit_equal_to_stream=check, build_s=build_s)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del staged, got
        torch.cuda.empty_cache()
        if not check:
            print("replay_occupancy: replay and stream tops differ",
                  file=sys.stderr)
            return 1
    print(json.dumps({"card": card, "trials": args.trials,
                      "stream_ms": stream_ms, "replay": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
