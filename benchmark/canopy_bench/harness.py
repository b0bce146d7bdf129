"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, one JSON line.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is a file the harness finds by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json`` (named by the configuration's
``file``), ``traffic/<mix>.json``, the mix's request kind
``kinds/<kind>.py`` (see ``cells``), ``metrics/<metric>.py`` (a reader
``read(run) -> float | None``) and ``limits/<workload>.json``.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback

__all__ = ["main", "FORBIDDEN"]

#: Top-level module names that may not be loaded when the result prints:
#: JAX and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "canopy_tpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entries and files, by name."""
    spec = _load_json(root, "BENCHMARK.json")
    (cell,) = [w for w in spec["workloads"] if w["name"] == workload]
    (config,) = [c for c in spec["configs"] if c["name"] == cell["config"]]
    return {"spec": spec, "cell": cell,
            **cell_files(root, spec["paths"][0], config["file"],
                         cell["traffic"], workload)}


def cell_files(root: str, bench_dir: str, config_file: str, traffic: str,
               workload: str) -> dict:
    """A cell's configuration, traffic mix and limits of ``correct``."""
    bench = os.path.join(root, bench_dir)
    return {"config": _load_json(root, config_file),
            "mix": _load_json(bench, "traffic", traffic + ".json"),
            "limits": _load_json(bench, "limits", workload + ".json"),
            "bench": bench}


def applies(entry: dict, workload: str, spec: dict) -> bool:
    """Whether a metric is reported in a cell: its ``workloads``, else
    (per-layer) wherever the end-to-end metric it moves is."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    moved = entry.get("moves")
    if moved is None:
        return True
    (e2e,) = [m for m in spec["end_to_end"] if m["name"] == moved]
    return applies(e2e, workload, spec)


def read_metric(bench: str, name: str, run) -> float | None:
    path = os.path.join(bench, "metrics", name + ".py")
    module_spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _environment(bench: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(bench, "_cache")
    for var, sub in (("XDG_CACHE_HOME", "xdg"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


class Run:
    """What a metric reader sees: ``workload``, ``config``, ``mix``,
    ``records`` (see ``cells``), ``window_s``, ``setup_s``, ``trace`` (a
    ``trace.Trace`` of a traced run on a card, else None), ``counters``
    (the program's counters across the window, else None) and
    ``roofline``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def window(cell, mix: dict, kind, seed: int, seconds: float, device):
    """The measured window, on one server that takes requests in the
    order they arrive.  Closed loop: each of ``clients`` clients sends a
    request at the start and its next one when the last returns, until
    ``seconds`` have passed and a round of the mix has been sent; the
    requests sent by then finish and count.  Open loop: the mix's
    arrivals, each request waiting until its time; every one finishes
    and counts.  A request's latency runs from its arrival to the return
    of its host result.  Returns (records, seconds, failed)."""
    import torch

    from . import traffic
    from .trace import span
    stream = traffic.requests(mix, kind, seed)
    if mix["loop"] == "open":
        queue = collections.deque(
            (t, next(stream)) for t in
            traffic.arrivals(mix, kind, seconds))
    else:
        queue = collections.deque((0.0, next(stream))
                                  for _ in range(mix["clients"]))
    sending = mix["loop"] == "closed"
    records, failed = [], 0
    t0 = time.perf_counter()
    with span("bench.window"):
        while queue:
            arrival, request = queue.popleft()
            wait = arrival - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            start = time.perf_counter()
            with span(kind.label(request)):
                try:
                    record = cell.run(request)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                except Exception:  # a failed request counts, the run goes on
                    traceback.print_exc()
                    failed += 1
                    record = {**request, "failed": True}
            end = time.perf_counter() - t0
            records.append({**record, "arrival": arrival,
                            "start": start - t0, "end": end})
            if sending:
                last = queue[-1][1] if queue else request
                if end >= seconds and last["round_end"]:
                    sending = False
                else:
                    queue.append((end, next(stream)))
    return records, records[-1]["end"], failed


def check(cell, records: list, mix: dict, kind, seed: int, device) -> dict:
    from . import traffic
    from .cells import make_reference
    reference = make_reference(kind, cell.paths, device)
    picked = [records[i]
              for i in traffic.check_sample(records, mix, kind, seed)]
    return cell.judge([r for r in picked if not r.get("failed")],
                      reference)


def _counters() -> dict | None:
    """The program's counters; None where it has none."""
    try:
        from canopy_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def _finite(x: float) -> float:
    return x if math.isfinite(x) else sys.float_info.max


def _window_summary(records: list, kind) -> str:
    """One line of the window's service times (milliseconds), by the
    kind's span name."""
    by_label: dict = {}
    for r in records:
        by_label.setdefault(kind.label(r), []).append(
            round((r["end"] - r["start"]) * 1e3, 1))
    return "window: " + "; ".join(
        f"{label}: {len(ms)} x median {sorted(ms)[len(ms) // 2]} max "
        f"{max(ms)}" for label, ms in sorted(by_label.items()))


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    got = load_cell(args.workload)
    cell_entry = got["cell"]
    _environment(got["bench"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell_entry["chips"]:
        print(f"{args.workload} needs {cell_entry['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import canopy_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test is missing: {exc}", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    return run_cell(got, args, device, t_start)


def run_cell(got: dict, args, device, t_start: float) -> int:
    """Set-up, window, check and result line on ``device`` (the tests
    call this on the CPU, past the look for a card)."""
    import torch

    from . import roofline, traffic
    from .cells import load_kind, make_cell
    from .trace import Tracer

    spec, bench = got["spec"], got["bench"]
    mix, config, limits = got["mix"], got["config"], got["limits"]
    kind = load_kind(bench, mix["kind"])
    try:
        traffic.validate(mix, kind)
    except ValueError as exc:
        print(f"traffic mix: {exc}", file=sys.stderr)
        return 2
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    cell = make_cell(config, mix, device, ROOT, kind)
    cell.setup()
    for request in traffic.warm_requests(mix, kind, args.seed):
        cell.run(request)
    if on_cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    with Tracer(bool(args.trace) and on_cuda) as tracer:
        before = _counters()
        records, window_s, failed = window(cell, mix, kind, args.seed,
                                           args.seconds, device)
        after = _counters()
    counted = None if before is None else \
        {k: v - before.get(k, 0) for k, v in after.items()}
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    cell.free()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    numbers = check(cell, records, mix, kind, args.seed, device)
    # A missing or non-finite reading prints as the largest float, so
    # the line stays strict JSON and the check still fails.
    checks = {name: {"value": _finite(numbers.get(name, math.inf)),
                     "limit": limit}
              for name, limit in limits["numbers"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    run = Run(workload=args.workload, config=config, mix=mix,
              records=records, window_s=window_s, setup_s=setup_s,
              trace=tracer.trace, counters=counted, roofline=roofline)
    t_reduce = time.perf_counter()
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for entry in spec[section]:
        if applies(entry, args.workload, spec):
            value = read_metric(bench, entry["name"], run)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if on_cuda else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if tracer.trace is not None:
        result["device"]["busy_s"] = tracer.trace.busy_s()
        result["device"]["window_s"] = tracer.trace.window_s
        result["breakdown"] = tracer.trace.breakdown()
        print(f"trace: exported and read in {tracer.read_s:.3f} s, "
              f"reduced in {time.perf_counter() - t_reduce:.3f} s",
              file=sys.stderr)
    result["checks"] = checks
    print(_window_summary(records, kind), file=sys.stderr)
    # Not part of ``correct``: every kernel is built before the window.
    print("builds in the window: "
          f"{'not counted' if counted is None else counted.get('builds')}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} <= {c['limit']!r}: "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
