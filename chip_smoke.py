"""Smoke run of the torch port on one CUDA card: kernels, then the slice.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (it exits
non-zero, printing no result, where ``torch.cuda.is_available()`` is
false or the package is missing).  Phases, each raising on failure:

1. the device: ``nvidia-smi`` name and power limit;
2. the kernel build (``nvcc`` for ``sm_90a`` from ``canopy_tpu_torch/csrc``);
3. every kernel against its plain PyTorch version on the card: the
   forward bit-equal at 1,048,576 trials on the slice's big BDD module and
   on the prod/pair/count tree programs of two fixtures; the logged
   forward and the backward, f32 and f64, bit-equal at 1 and 1,024
   trials, and the backward within ``GRAD_RTOL`` of torch autograd
   through the f64 plain forward; CUDA-event times of kernel and plain;
4. the slice, through the CLI in-process
   (``tests/fixtures/torch_slice_plant.xml --device cuda --bdd
   --importance --uncertainty --num-trials 1048576 --seed 7``): every
   kernel launched, the stream method tag, probability / MIF / cut-set
   count against ``tests/fixtures/torch_slice_golden.json``, and the
   kernel's per-trial tops of 65,536 sampled trials against the f64 level
   evaluation of the same samples.

Long output goes to ``chiprun_out/``.  The last lines are the kernels'
JSON record, the card's ``nvidia-smi`` line, and the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SLICE_MODEL = os.path.join(FIXTURES, "torch_slice_plant.xml")
SLICE_GOLDEN = os.path.join(FIXTURES, "torch_slice_golden.json")
SLICE_TRIALS = 1 << 20
SLICE_SEED = 7
AGREE_TRIALS = 65_536

#: Backward kernel against autograd through the f64 plain forward, as the
#: per-trial normwise relative error (largest error over largest
#: gradient).  f32 partials of a Shannon mux lose digits where hi and lo
#: nearly cancel, so single entries can be far off in relative terms; the
#: f64 kernels (importance's path) carry no such loss.
GRAD_RTOL = {"f32": 1e-4, "f64": 1e-12}
#: Probability against the frozen f64 JAX value (same f64 level order).
PROB_RTOL = 1e-12
#: MIF of the (f64) adjoint kernel against the frozen f64 JAX MIF, for
#: every event above 1e-6 of the largest MIF.
MIF_RTOL = 1e-4
#: Per-trial f32 kernel tops against the f64 level evaluation.
TOP_RTOL = 1e-5

KERNELS = {
    "stream": ("canopy_tpu_torch/csrc/stream.cu",
               "canopy_tpu/ops/stream_kernel.py:135"),
    "stream_log": ("canopy_tpu_torch/csrc/stream.cu",
                   "canopy_tpu/ops/adjoint_kernel.py:40"),
    "adjoint": ("canopy_tpu_torch/csrc/adjoint.cu",
                "canopy_tpu/ops/adjoint_kernel.py:164"),
}


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
    tree_name = "slice" if name == "torch_slice_plant" else name
    return compile_fault_tree(model.fault_trees.get(tree_name))


def phase_build() -> None:
    from canopy_tpu_torch.ops._build import build_info, load_library
    t0 = time.perf_counter()
    lib = load_library()
    info = build_info()
    log(f"[build] {time.perf_counter() - t0:.3f} s (nvcc "
        f"{info['seconds']:.3f} s, built={info['built']}): {info['path']}")
    if info.get("cmd"):
        log(f"[build] {info['cmd']}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] ptxas {line.strip()}")
    from canopy_tpu_torch.ops.stream_kernel import MAX_COUNT_STATES
    check(lib.canopy_max_count_states() == MAX_COUNT_STATES,
          "kernel and wrapper disagree on the count-DP bound")


def programs():
    """(label, encoded program, house) of every program phase 3 checks."""
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    from canopy_tpu_torch.ops.stream_kernel import (compile_bdd_stream,
                                                    compile_stream,
                                                    encode_stream)
    out = []
    slice_tree = load_tree("torch_slice_plant")
    for bdd, _slot in build_modular_bdd(slice_tree).chain:
        if bdd.n_nodes >= 256:
            out.append((f"slice-module-{bdd.n_nodes}",
                        encode_stream(compile_bdd_stream(bdd)), []))
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


def phase_kernels(device, record: dict) -> None:
    from canopy_tpu_torch.ops.adjoint_kernel import (stream_backward,
                                                     stream_backward_plain)
    from canopy_tpu_torch.ops.stream_kernel import (house_tensor,
                                                    stream_forward,
                                                    stream_forward_plain)
    progs = programs()
    kinds = set()
    for label, enc, house in progs:
        kinds |= {int(k) for k in enc.ops[:, 0]}
    check({0, 1, 2, 3} <= kinds, "programs must cover prod/pair/count/mux")
    gen = torch.Generator(device=device)
    gen.manual_seed(20260)

    def probabilities(shape, dtype=torch.float32):
        # PRA-scale inputs, as bench.py's bdd-stream section draws them.
        return (torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float64) * 0.02).to(dtype)

    for label, enc, house in progs:
        main = label.startswith("slice-module")
        h32 = house_tensor(enc, house, device)
        # Forward at the uncertainty batch size, f32 as uncertainty runs.
        staged = probabilities((enc.n_basic, SLICE_TRIALS))
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
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if main:
            record["stream"].update(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms,
                                    shape=f"{enc.n_ops} ops x "
                                          f"{SLICE_TRIALS} trials, f32")
        del staged, top, plain
        torch.cuda.empty_cache()
        # Logged forward and backward, in both value types, at 1 trial
        # (importance's shape, f64 on the main path) and 1,024 trials.
        for n in (1, 1024):
            for dtype in (torch.float64, torch.float32):
                name = "f64" if dtype == torch.float64 else "f32"
                staged = probabilities((enc.n_basic, n), dtype)
                ct = (torch.rand(n, generator=gen, device=device,
                                 dtype=torch.float64) + 0.5).to(dtype)
                hd = h32.to(dtype)
                top, vlog = stream_forward(enc, staged, house,
                                           with_log=True)
                ptop, plog = stream_forward_plain(enc, staged, hd, True)
                grad = stream_backward(enc, staged, house, vlog, ct)
                pgrad = stream_backward_plain(enc, staged, hd, plog, ct)
                torch.cuda.synchronize()
                log_err = float((vlog - plog).abs().max())
                grad_err = float((grad - pgrad).abs().max())
                check(torch.equal(top, ptop) and log_err == 0.0,
                      f"{label}: {name} logged forward differs at {n}")
                check(grad_err == 0.0,
                      f"{label}: {name} backward differs from plain at "
                      f"{n} trials ({grad_err})")
                # Autograd through the f64 plain forward.
                s64 = staged.double().requires_grad_(True)
                t64, _ = stream_forward_plain(enc, s64, h32.double())
                (g64,) = torch.autograd.grad(t64, s64, ct.double())
                rel = _grad_error(grad, g64)
                limit = GRAD_RTOL[name]
                check(rel <= limit, f"{label}: {name} backward vs f64 "
                                    f"autograd {rel:.3e} > {limit}")
                ms_log = cuda_ms(lambda: stream_forward(
                    enc, staged, house, with_log=True), 5)
                ms_bwd = cuda_ms(lambda: stream_backward(
                    enc, staged, house, vlog, ct), 5)
                pms_log = cuda_ms(lambda: stream_forward_plain(
                    enc, staged, hd, True), 1)
                pms_bwd = cuda_ms(lambda: stream_backward_plain(
                    enc, staged, hd, plog, ct), 1)
                log(f"[kernels] {label}: {name} logged forward + backward "
                    f"at {n} trials bit-equal to plain; backward vs f64 "
                    f"autograd {rel:.3e} (limit {limit}); log kernel "
                    f"{ms_log:.3f} ms / plain {pms_log:.3f} ms; adjoint "
                    f"kernel {ms_bwd:.3f} ms / plain {pms_bwd:.3f} ms")
                if main and n == 1 and name == "f64":
                    record["stream_log"].update(
                        max_abs_err=log_err, ms=ms_log, plain_ms=pms_log,
                        shape=f"{enc.n_ops} ops x 1 trial, f64")
                    record["adjoint"].update(
                        max_abs_err=grad_err, ms=ms_bwd, plain_ms=pms_bwd,
                        shape=f"{enc.n_ops} ops x 1 trial, f64")
                if main:
                    record.setdefault("timings", {})[f"{name}@{n}"] = {
                        "log_ms": ms_log, "log_plain_ms": pms_log,
                        "adjoint_ms": ms_bwd, "adjoint_plain_ms": pms_bwd}


def phase_slice(device, record: dict) -> None:
    from canopy_tpu_torch.cli import main as cli_main
    from canopy_tpu_torch.compiler.modules import (build_modular_bdd,
                                                   modular_probability)
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.bdd_eval import make_modular_evaluator
    from canopy_tpu_torch.engine.uncertainty import \
        sample_basic_probabilities
    from canopy_tpu_torch.ops.stream_kernel import LAUNCHES, reset_launches

    with open(SLICE_GOLDEN) as fh:
        golden = json.load(fh)
    report_path = os.path.join(OUT_DIR, "torch_slice_report.json")
    argv = [SLICE_MODEL, "--device", "cuda", "--bdd", "--importance",
            "--uncertainty", "--num-trials", str(SLICE_TRIALS), "--seed",
            str(SLICE_SEED), "-o", report_path]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(rc == 0, f"CLI exited {rc}")
    log(f"[slice] python -m canopy_tpu_torch {' '.join(argv)}: "
        f"{seconds:.3f} s, launches {launches}")
    for name in KERNELS:
        record[name]["launches"] = launches[name]
        check(launches[name] > 0, f"kernel {name} never launched")
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

    # Per-trial agreement: redraw the run's one batch (key = (seed, 0)),
    # check that the kernel reproduces the reported mean, then hold 65,536
    # of its trials against the f64 level evaluation.
    from canopy_tpu_torch.settings import Settings
    tree = load_tree("torch_slice_plant")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    modular = build_modular_bdd(tree)
    samples = sample_basic_probabilities(tape, (SLICE_SEED, 0),
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
    phase_build()
    record = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": rep} for name, (src, rep) in
              KERNELS.items()}
    phase_kernels(device, record)
    phase_slice(device, record)
    check("jax" not in sys.modules, "the port imported jax")
    kernels = [{k: record[name][k] for k in
                ("name", "route", "source", "replaces", "launches",
                 "max_abs_err", "ms", "plain_ms")} for name in KERNELS]
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
