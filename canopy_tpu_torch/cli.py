"""Command-line entry point of the torch port (``canopy_tpu/cli.py``'s flags).

    python -m canopy_tpu_torch MODEL.xml [MODEL2.xml ...] [options]

Examples:
    python -m canopy_tpu_torch plant.xml --probability --ccf
    python -m canopy_tpu_torch plant.xml --bdd --importance --uncertainty \
        --num-trials 1048576 --seed 7 -o report.xml
    python -m canopy_tpu_torch plant.xml --device cpu --rare-event
    python -m canopy_tpu_torch --project project.xml

``--device`` (default ``cuda``) names where the analysis runs; with no
usable CUDA device the run stops with an error instead of moving to the
CPU.  ``--project`` files are validated against the bundled project
grammar (``io/xml.Validator``); their input files come before the
positional ones, and flags given on the command line override their
options.  ``--validate [SCHEMA]`` validates every input file against a
RELAX NG grammar (default: the bundled MEF grammar) with the same
interpreter.
"""

from __future__ import annotations

import argparse
import sys

from .errors import Error
from .settings import Settings


class _VersionAction(argparse.Action):
    """Lazy --version: the git subprocesses (commit/count/dirty) run
    only when the flag is actually given, not on every CLI start."""

    def __call__(self, parser, namespace, values, option_string=None):
        from .build_info import version_string
        print(version_string())
        parser.exit()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="canopy-tpu-torch",
        description="Quantification of Open-PSA MEF models on PyTorch "
                    "and CUDA.")
    parser.add_argument("--version", action=_VersionAction, nargs=0,
                        help="build version (git-derived when available)")
    parser.add_argument("input_files", nargs="*",
                        help="MEF XML input files (globs allowed)")
    parser.add_argument("--project", metavar="PROJECT_XML",
                        help="load input files + options from a project "
                             "file (CLI flags override its options)")
    parser.add_argument("-o", "--output", default=None,
                        help="write the report to this file "
                             "(.xml or .json by extension; default stdout "
                             "JSON)")
    parser.add_argument("--validate", metavar="SCHEMA", nargs="?",
                        const="__default__", default=None,
                        help="validate inputs against a RELAX NG schema "
                             "(default: the bundled MEF grammar)")
    parser.add_argument("--allow-extern", action="store_true",
                        help="allow define-extern-library (dlopen!)")

    algo = parser.add_mutually_exclusive_group()
    algo.add_argument("--bdd", action="store_true",
                      help="exact BDD analysis (default)")
    algo.add_argument("--zbdd", action="store_true")
    algo.add_argument("--mocus", action="store_true")
    algo.add_argument("--pdag", action="store_true",
                      help="direct propagation over the gate DAG")

    approx = parser.add_mutually_exclusive_group()
    approx.add_argument("--rare-event", action="store_true")
    approx.add_argument("--mcub", action="store_true")
    approx.add_argument("--monte-carlo", action="store_true")

    parser.add_argument("--prime-implicants", action="store_true")
    parser.add_argument("--probability", action="store_true")
    parser.add_argument("--importance", action="store_true")
    parser.add_argument("--uncertainty", action="store_true")
    parser.add_argument("--ccf", action="store_true")
    parser.add_argument("--sil", action="store_true",
                        help="safety-integrity-level metrics "
                             "(requires --time-step)")
    parser.add_argument("--skip-products", action="store_true")
    parser.add_argument("--preprocessor", action="store_true",
                        help="stop after model setup; report structure only")

    parser.add_argument("--limit-order", type=int, metavar="N")
    parser.add_argument("--cut-off", type=float, metavar="P")
    parser.add_argument("--num-trials", type=int, metavar="N")
    parser.add_argument("--batch-size", type=int, metavar="N")
    parser.add_argument("--sample-size", type=int, metavar="N")
    parser.add_argument("--num-quantiles", type=int, metavar="N")
    parser.add_argument("--num-bins", type=int, metavar="N")
    parser.add_argument("--seed", type=int, metavar="S")
    parser.add_argument("--mission-time", type=float, metavar="T")
    parser.add_argument("--time-step", type=float, metavar="T")
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="the torch device the analysis runs on "
                             "(default cuda; no silent CPU fallback)")
    parser.add_argument("--profile", metavar="LOG_DIR", default=None,
                        help="write a torch.profiler trace of the "
                             "analysis to this directory")
    parser.add_argument("--verbosity", type=int, default=0)
    return parser


def settings_from_args(args, base: Settings | None = None) -> Settings:
    """Build Settings with the same ordering semantics as the reference
    (algorithm first — it sets approximation defaults — then overrides).

    With ``base`` (from a project file), only explicitly-given CLI flags
    override the project's options.
    """
    settings = base if base is not None else Settings()
    if args.zbdd:
        settings.algorithm("zbdd")
    elif args.mocus:
        settings.algorithm("mocus")
    elif args.pdag:
        settings.algorithm("pdag")
    elif args.bdd or base is None:
        settings.algorithm("bdd")
    if args.rare_event:
        settings.approximation("rare-event")
    elif args.mcub:
        settings.approximation("mcub")
    elif args.monte_carlo:
        settings.approximation("monte-carlo")
    if args.prime_implicants:
        settings.prime_implicants(True)
    for name, setter in [("limit_order", settings.limit_order),
                         ("cut_off", settings.cut_off),
                         ("num_trials", settings.num_trials),
                         ("batch_size", settings.batch_size),
                         ("sample_size", settings.sample_size),
                         ("num_quantiles", settings.num_quantiles),
                         ("num_bins", settings.num_bins),
                         ("seed", settings.seed),
                         ("mission_time", settings.mission_time),
                         ("time_step", settings.time_step)]:
        value = getattr(args, name)
        if value is not None:
            setter(value)
    if args.probability:
        settings.probability_analysis(True)
    if args.importance:
        settings.importance_analysis(True)
    if args.uncertainty:
        settings.uncertainty_analysis(True)
    if args.sil:
        settings.safety_integrity_levels(True)
    if args.ccf:
        settings.ccf_analysis(True)
    if args.skip_products:
        settings.skip_products(True)
    if args.preprocessor:
        settings.preprocessor = True
    return settings


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        from ._device import resolve_device
        device = resolve_device(args.device)
        input_files = list(args.input_files)
        output = args.output
        if args.project:
            from .project import load_project
            project = load_project(args.project)
            input_files = project.input_files + input_files
            settings = settings_from_args(args, base=project.settings)
            if output is None:
                output = project.output
        else:
            settings = settings_from_args(args)
        if not input_files:
            print("error: no input files (positional or --project)",
                  file=sys.stderr)
            return 2
        args.output = output
        schema = args.validate
        if schema == "__default__":
            from .schemas import default_schema_path
            schema = default_schema_path()
        from .mef.initializer import Initializer
        init = Initializer(input_files, settings,
                           allow_extern=args.allow_extern,
                           schema_path=schema)
        from .engine.analysis import RiskAnalysis
        from .utils.profiling import trace
        with trace(args.profile, cuda=device.type == "cuda"):
            report = RiskAnalysis(init.model, settings, device).run()
    except (Error, NotImplementedError) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1

    if args.output and args.output.endswith(".xml"):
        from .report import report_to_xml
        payload = report_to_xml(report)
        with open(args.output, "wb") as fh:
            fh.write(payload)
    elif args.output:
        with open(args.output, "w") as fh:
            fh.write(report.to_json(indent=2))
    else:
        print(report.to_json(indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
