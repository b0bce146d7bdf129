"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level module names compared whole: the program's name begins with
the JAX package's)."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

FORBIDDEN = {"jax", "jaxlib", "flax", "canopy_tpu"}

SCRIPT = """
import glob, importlib.util, json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
for sub in ("metrics", "kinds"):
    for path in glob.glob(os.path.join({bench!r}, sub, "*.py")):
        spec = importlib.util.spec_from_file_location("m", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(imports: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(bench=BENCH, root=ROOT,
                                             imports=imports)],
        capture_output=True, text=True, check=True, env=env, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_any_canopy_package():
    names = top_level_names(
        "import canopy_bench.reference, canopy_bench.judge, "
        "canopy_bench.cells")
    assert not names & FORBIDDEN
    assert "canopy_tpu_torch" not in names


def test_harness_and_program_load_no_jax():
    names = top_level_names(
        "import canopy_bench.harness, canopy_bench.cells, "
        "canopy_bench.calibrate, canopy_bench.trace\n"
        "import canopy_tpu_torch.engine.analysis, "
        "canopy_tpu_torch.engine.uncertainty, canopy_tpu_torch.mef, "
        "canopy_tpu_torch.compiler.modules, canopy_tpu_torch.engine.bdd_eval")
    assert "canopy_tpu_torch" in names
    assert not names & FORBIDDEN
