"""Readings for the limits of ``correct``: the program's worst gaps on a
dozen seeds or more, and the control's (the reference in the next lower
precision, in the program's place) on three or more, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 3

Each seed runs a short window at the cell's own load, as a benchmark run
does, and its sample of answers is judged as a run judges it.  One JSON
line per seed, then a summary: per number the largest program reading
(the lower one) and the smallest control reading (the upper one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, traffic
from .cells import load_kind, make_cell, make_reference


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--first-seed", type=int, default=4_000_000_001)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    got = harness.load_cell(args.workload)
    harness._environment(got["bench"])
    device = torch.device(args.device)
    kind = load_kind(got["bench"], got["mix"]["kind"])
    traffic.validate(got["mix"], kind)
    cell = make_cell(got["config"], got["mix"], device, harness.ROOT, kind)
    cell.setup()
    for request in traffic.warm_requests(got["mix"], kind, args.first_seed):
        cell.run(request)
    reference = make_reference(kind, cell.paths, device)
    lower: dict = {}
    upper: dict = {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        records, _s, failed = harness.window(cell, got["mix"], kind, seed,
                                             args.seconds, device)
        picked = [records[i] for i in
                  traffic.check_sample(records, got["mix"], kind, seed)]
        numbers = cell.judge(picked, reference)
        line = {"seed": seed, "failed": failed, "requests": len(records),
                "program": numbers}
        for name, value in numbers.items():
            lower[name] = max(lower.get(name, 0.0), value)
        if k < args.control_seeds:
            control = cell.judge(picked, reference, control=True)
            line["control"] = control
            for name, value in control.items():
                upper[name] = min(upper.get(name, float("inf")), value)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper,
                      "device": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
