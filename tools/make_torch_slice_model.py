"""Write the torch port's slice model and its frozen JAX reference values.

The model is the exact-BDD tree of ``bench.py``'s ``bdd-stream`` section
(``synthetic_mef_tree(n_basic=300, n_gates=260, fanin=3, seed=9,
atleast_fraction=0.1, complement_fraction=0.0)``: 300 basic events, 260
gates, about 10 % 2-of-k vote gates) with every basic event's constant
replaced by a ``lognormal-deviate`` of that mean, error factor 3 at level
0.95 (the usual PRA parameter uncertainty).  It is serialised with
``canopy_tpu.io.mef_writer`` into ``tests/fixtures/torch_slice_plant.xml``.

The reference values go to ``tests/fixtures/torch_slice_golden.json``,
computed with the JAX package in f64 on the CPU from the written file:
the exact top probability at the mean values, MIF/RAW/RRW of every basic
event, the number of minimal cut sets, and the modular BDD's sizes.

Run once from the repository root (it takes a few minutes on a CPU):

    JAX_PLATFORMS=cpu python tools/make_torch_slice_model.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from canopy_tpu.compiler.graph import compile_fault_tree  # noqa: E402
from canopy_tpu.compiler.modules import build_modular_bdd  # noqa: E402
from canopy_tpu.compiler.schedule import build_bdd_stream_schedule  # noqa: E402
from canopy_tpu.engine.analysis import RiskAnalysis  # noqa: E402
from canopy_tpu.io.mef_writer import model_to_mef_xml  # noqa: E402
from canopy_tpu.mef import Initializer  # noqa: E402
from canopy_tpu.mef.event import Gate  # noqa: E402
from canopy_tpu.mef.expr.constant import ConstantExpression  # noqa: E402
from canopy_tpu.mef.expr.random_deviate import LognormalDeviate  # noqa: E402
from canopy_tpu.mef.fault_tree import FaultTree  # noqa: E402
from canopy_tpu.mef.model import Model  # noqa: E402
from canopy_tpu.settings import Settings  # noqa: E402
from canopy_tpu.utils.synthetic import synthetic_mef_tree  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MODEL_PATH = os.path.join(FIXTURES, "torch_slice_plant.xml")
GOLDEN_PATH = os.path.join(FIXTURES, "torch_slice_golden.json")
TREE_NAME = "slice"


def build_model() -> Model:
    top, events = synthetic_mef_tree(n_basic=300, n_gates=260, fanin=3,
                                     seed=9, atleast_fraction=0.1,
                                     complement_fraction=0.0)
    gates: list[Gate] = []
    seen: set[str] = set()
    stack = [top]
    while stack:
        gate = stack.pop()
        if gate.id in seen:
            continue
        seen.add(gate.id)
        gates.append(gate)
        stack.extend(a.event for a in gate.formula.args
                     if isinstance(a.event, Gate))
    for event in events:
        mean = event.expression.value()
        event.expression = LognormalDeviate(
            ConstantExpression(mean), ConstantExpression(3.0),
            ConstantExpression(0.95))
    model = Model("torch-slice-plant")
    fault_tree = FaultTree(TREE_NAME)
    for gate in gates:
        fault_tree.add_gate(gate)
    for event in events:
        fault_tree.add_basic_event(event)
    model.fault_trees.add(fault_tree)
    return model


def main() -> None:
    with open(MODEL_PATH, "wb") as fh:
        fh.write(model_to_mef_xml(build_model()))

    settings = (Settings().algorithm("bdd").probability_analysis(True)
                .importance_analysis(True))
    model = Initializer([MODEL_PATH], settings).model
    report = RiskAnalysis(model, settings).run()
    (result,) = report.fault_trees
    fault_tree = model.fault_trees.get(TREE_NAME)
    tree = compile_fault_tree(fault_tree)
    modular = build_modular_bdd(tree)
    module_nodes = [bdd.n_nodes for bdd, _slot in modular.chain]
    big = max(modular.chain, key=lambda pair: pair[0].n_nodes)[0]
    program = build_bdd_stream_schedule(big)
    golden = {
        "model": os.path.basename(MODEL_PATH),
        "top_event": result.top_event,
        "derivation": "canopy_tpu RiskAnalysis (bdd, importance), f64, "
                      "JAX on the CPU; tools/make_torch_slice_model.py",
        "n_basic": tree.n_basic,
        "n_gates": tree.n_gates,
        "exact_probability": result.probability,
        "n_products": result.n_products,
        "module_nodes": module_nodes,
        "largest_module_stream_ops": sum(
            1 for op in program.ops if op[0] == "gate"),
        "largest_module_pool_slots": program.pool_slots,
        "importance": {row["event"]: {k: row[k] for k in
                                      ("MIF", "RAW", "RRW")}
                       for row in result.importance},
    }
    with open(GOLDEN_PATH, "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {MODEL_PATH} and {GOLDEN_PATH}: P = "
          f"{result.probability!r}, {result.n_products} cut sets, "
          f"modules {module_nodes}")


if __name__ == "__main__":
    main()
