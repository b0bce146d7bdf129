"""Write the frozen JAX reference of the slice model's direct-propagation path.

The torch port runs ``RiskAnalysis`` with ``algorithm("pdag")`` and
``approximation("none")`` on ``tests/fixtures/torch_slice_plant.xml``: no
BDD is built, the probability is the f64 gather engine's, importance
differentiates the gate graph, and the cut sets come from MOCUS.  This
script computes the same with the JAX package in f64 on the CPU and
writes ``tests/fixtures/torch_pdag_golden.json``: the probability,
MIF/RAW/RRW of every basic event, and the cut-set count.  The machine
with the card has no JAX, so the port's tests and ``chip_smoke.py`` read
the file instead.

Run from the repository root (about a minute on a CPU):

    JAX_PLATFORMS=cpu python tools/make_torch_pdag_golden.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from canopy_tpu.engine.analysis import RiskAnalysis  # noqa: E402
from canopy_tpu.mef import Initializer  # noqa: E402
from canopy_tpu.settings import Settings  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MODEL_PATH = os.path.join(FIXTURES, "torch_slice_plant.xml")
GOLDEN_PATH = os.path.join(FIXTURES, "torch_pdag_golden.json")


def main() -> None:
    settings = (Settings().algorithm("pdag").approximation("none")
                .probability_analysis(True).importance_analysis(True))
    model = Initializer([MODEL_PATH], settings).model
    report = RiskAnalysis(model, settings).run()
    (result,) = report.fault_trees
    golden = {
        "model": os.path.basename(MODEL_PATH),
        "top_event": result.top_event,
        "method": result.method,
        "derivation": "canopy_tpu RiskAnalysis (pdag, approximation none, "
                      "importance), f64, JAX on the CPU; "
                      "tools/make_torch_pdag_golden.py",
        "probability": result.probability,
        "n_products": result.n_products,
        "importance": {row["event"]: {k: row[k] for k in
                                      ("MIF", "RAW", "RRW")}
                       for row in result.importance},
    }
    with open(GOLDEN_PATH, "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {GOLDEN_PATH}: P = {result.probability!r}, "
          f"{result.n_products} cut sets, method {result.method}")


if __name__ == "__main__":
    main()
