"""The fused kernel against its other design, and the stream kernel.

A tree's live-row program (``ops/fused_kernel.fused_program``) runs
through ``csrc/replay_ops.cuh``'s ring body in either of two forms:

* rows in device memory: the fused kernel (``csrc/fused.cu``,
  ``fused_forward`` in the ``fused_plan`` shape), one column per trial,
  shared memory holding only the op-stream chunks and the prefetch ring;
* rows in shared memory: the spill kernel (``csrc/spill.cu``; the
  program is an eviction-free spill program) in the
  ``stream_kernel.replay_plan`` shape, where the rows set how many
  trials an SM holds.

This script runs both on ``chip_smoke.py`` phase 4's fixtures (the slice
tree, ``demo_plant``, ``aralia_like_large``, ``aralia_like_nested_count``)
at 1,048,576 uniform(0, 0.02) float32 trials drawn on the card (seed
20261), checks both and the stream kernel bit-equal to
``fused_forward_plain``, and times the three with CUDA events on the same
inputs.

Run from the repository root on a machine with one CUDA card:

    python3 tools/fused_leads.py [--trials 1048576] [--reps 5]

It prints one line per tree and, last, one JSON object with every number
and the card's ``nvidia-smi`` name and power limit; it exits non-zero
without a CUDA device or when a kernel differs from plain.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import cuda_ms, load_tree, nvidia_smi  # noqa: E402

FIXTURES = ("torch_slice_plant", "demo_plant", "aralia_like_large",
            "aralia_like_nested_count")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=1 << 20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fused_leads: needs a CUDA device", file=sys.stderr)
        return 1
    from canopy_tpu_torch.ops.fused_kernel import (encode_fused,
                                                   fused_forward,
                                                   fused_forward_plain,
                                                   fused_plan)
    from canopy_tpu_torch.ops.stream_kernel import (house_tensor,
                                                    replay_plan,
                                                    spill_forward,
                                                    stream_forward,
                                                    tree_stream_encoding)
    device = torch.device("cuda")
    card = nvidia_smi()
    gen = torch.Generator(device=device)
    gen.manual_seed(20261)
    out, ok = [], True
    for name in FIXTURES:
        tree = load_tree(name)
        enc = encode_fused(tree)
        live, plan = fused_plan(enc)
        shared_plan = replay_plan(live, torch.float32, args.trials)
        house = tree.house_state_vector()
        h32 = house_tensor(enc, house, device)
        staged = (torch.rand((enc.n_basic, args.trials), generator=gen,
                             device=device, dtype=torch.float64)
                  * 0.02).to(torch.float32)
        want = fused_forward_plain(enc, staged, h32)
        senc = tree_stream_encoding(tree)
        sstaged = staged[torch.from_numpy(senc.staged_cols).to(device)]
        runs = {"device_rows": lambda: fused_forward(enc, staged, house),
                "shared_rows": lambda: spill_forward(live, staged, house),
                "stream": lambda: stream_forward(senc, sstaged, house)[0]}
        row = dict(tree=name, gates=enc.n_ops, rows=live.pool_slots,
                   device_plan=[plan.width, plan.depth],
                   shared_plan=[shared_plan.width, shared_plan.depth,
                                shared_plan.shared_bytes])
        for key, run in runs.items():
            equal = torch.equal(run(), want)
            ok &= equal
            row[f"{key}_ms"] = cuda_ms(run, args.reps)
            row[f"{key}_bit_equal"] = equal
        out.append(row)
        print(f"[fused_leads] {json.dumps(row)}", flush=True)
        del staged, sstaged, want
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "trials": args.trials, "trees": out}))
    if not ok:
        print("fused_leads: a kernel differs from plain", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
