"""Write the torch port's plant-width event tree and its frozen JAX values.

The model links an event tree to the slice plant
(``tests/fixtures/torch_slice_plant.xml``, written by
``tools/make_torch_slice_model.py``: 300 basic events, 260 gates).  The
written file holds only what it adds, and is loaded after the slice
plant (``Initializer([torch_slice_plant.xml, torch_event_tree_plant.xml])``,
or both files on the command line): an
initiating event ``IE`` whose initial state collects the basic event
``ie-occurs`` (lognormal, mean 0.01, error factor 3), then six binary
functional events.  System ``k`` is the gate ``sys{k}``, the one top of
fault tree ``system{k}``, an OR of the slice top's children ``k, k + 6,
k + 12, ...`` (file order); a success
path collects ``not sys{k}``, a failure path ``sys{k}``, so the 2^6 = 64
sequences ``seq{bits}`` (bit ``k`` set: system ``k`` failed) cover every
combination.  The systems share basic events through the slice's DAG.

The reference values go to ``tests/fixtures/torch_event_tree_golden.json``,
computed with the JAX package in f64 on the CPU from the two files:
every sequence's probability from the JAX package's event-tree analysis under
default Settings, and the size at which its BDD forest gave up
(``build_bdd_multi`` over the 64 roots raises ``BddBlowupError`` at its
2,000,000-node limit, so the values come from the direct-propagation
fallback).  Beside them, under ``fixtures``, the JAX reports' values of
the event-tree and alignment fixtures under default Settings with
probability analysis (sequence probabilities; each fault-tree result's
probability, keyed ``top`` or ``top@alignment/phase``), and under
``sil_slice`` the slice plant's SIL metrics and curve
(``time_step(100)``, ``safety_integrity_levels(True)``, products
skipped), which the JAX package takes about two minutes to compute.

Run once from the repository root (about three minutes on a CPU):

    JAX_PLATFORMS=cpu python tools/make_torch_event_tree_model.py
"""

from __future__ import annotations

import json
import os
import sys
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from canopy_tpu.compiler.bdd import (BddBlowupError,  # noqa: E402
                                     build_bdd_multi)
from canopy_tpu.compiler.graph import compile_gates  # noqa: E402
from canopy_tpu.engine.analysis import RiskAnalysis  # noqa: E402
from canopy_tpu.engine.event_tree_walk import walk_event_tree  # noqa: E402
from canopy_tpu.mef import Initializer  # noqa: E402
from canopy_tpu.settings import Settings  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SLICE_PATH = os.path.join(FIXTURES, "torch_slice_plant.xml")
MODEL_PATH = os.path.join(FIXTURES, "torch_event_tree_plant.xml")
GOLDEN_PATH = os.path.join(FIXTURES, "torch_event_tree_golden.json")
INPUTS = [SLICE_PATH, MODEL_PATH]
N_FE = 6
FOREST_LIMIT = 2_000_000
#: Fixtures whose JAX values ``chip_smoke.py`` holds the port's CLI to.
FIXTURE_NAMES = ("hand_event_tree", "demo_plant", "station_blackout",
                 "aralia_like_alignment")


def _sub(parent: ET.Element, tag: str, **attrs) -> ET.Element:
    return ET.SubElement(parent, tag, {k.replace("_", "-"): str(v)
                                       for k, v in attrs.items()})


def _fork(parent: ET.Element, k: int, bits: int) -> None:
    if k == N_FE:
        _sub(parent, "sequence", name=f"seq{bits}")
        return
    fork = _sub(parent, "fork", functional_event=f"FE{k}")
    for state, failed in (("success", False), ("failure", True)):
        path = _sub(fork, "path", state=state)
        collect = _sub(path, "collect-formula")
        if failed:
            _sub(collect, "gate", name=f"sys{k}")
        else:
            _sub(_sub(collect, "not"), "gate", name=f"sys{k}")
        _fork(path, k + 1, bits | (1 << k) if failed else bits)


def build_xml() -> bytes:
    top = next(g for g in ET.parse(SLICE_PATH).getroot().iter("define-gate")
               if g.get("name") == "synthetic-top")
    children = [c.get("name") for c in top.find("or")]
    root = ET.Element("opsa-mef", {"name": "torch-event-tree-plant"})
    _sub(root, "define-initiating-event", name="IE",
         event_tree="PlantResponse")
    tree = _sub(root, "define-event-tree", name="PlantResponse")
    for k in range(N_FE):
        _sub(tree, "define-functional-event", name=f"FE{k}")
    for bits in range(2 ** N_FE):
        _sub(tree, "define-sequence", name=f"seq{bits}")
    initial = _sub(tree, "initial-state")
    _sub(_sub(initial, "collect-formula"), "basic-event", name="ie-occurs")
    _fork(initial, 0, 0)

    # One top per fault tree: a fault tree's top events come out of the
    # MEF layer in no fixed order, and tools compile a tree at its first.
    for k in range(N_FE):
        system = _sub(root, "define-fault-tree", name=f"system{k}")
        body = _sub(_sub(system, "define-gate", name=f"sys{k}"), "or")
        for child in children[k::N_FE]:
            _sub(body, "gate", name=child)
    event = _sub(_sub(root, "model-data"), "define-basic-event",
                 name="ie-occurs")
    deviate = _sub(event, "lognormal-deviate")
    for value in ("0.01", "3", "0.95"):
        _sub(deviate, "float", value=value)
    ET.indent(root, "  ")
    return ET.tostring(root, encoding="UTF-8", xml_declaration=True) + b"\n"


def fixture_values(name: str) -> dict:
    """The JAX report's sequence and fault-tree probabilities."""
    settings = Settings().probability_analysis(True)
    model = Initializer([os.path.join(FIXTURES, f"{name}.xml")],
                        settings).model
    report = RiskAnalysis(model, settings).run()
    tops = {}
    for r in report.fault_trees:
        key = r.top_event if r.phase is None else \
            f"{r.top_event}@{r.alignment}/{r.phase}"
        tops[key] = r.probability
    return {"sequences": {s.sequence: s.probability
                          for s in report.sequences},
            "fault_trees": tops}


def sil_slice() -> dict:
    """The slice plant's SIL metrics and time curve."""
    settings = (Settings().probability_analysis(True).time_step(100.0)
                .safety_integrity_levels(True).skip_products(True))
    model = Initializer([SLICE_PATH], settings).model
    (result,) = RiskAnalysis(model, settings).run().fault_trees
    return {"time_step": 100.0, "sil": result.sil,
            "time_curve": [list(point) for point in result.time_curve]}


def main() -> None:
    with open(MODEL_PATH, "wb") as fh:
        fh.write(build_xml())

    settings = Settings()
    model = Initializer(INPUTS, settings).model
    (initiating,) = model.initiating_events
    outcomes = walk_event_tree(model, initiating)
    gates = [o.conjoined_gate(f"__seq{i}__") for i, o in enumerate(outcomes)]
    tree = compile_gates(gates, use_ccf=settings.ccf_analysis())
    t0 = time.perf_counter()
    try:
        build_bdd_multi(tree, [tree.gate_index[g.id] for g in gates],
                        max_nodes=FOREST_LIMIT,
                        house_states=tree.house_state_vector())
        raise SystemExit("the forest fits: the fixture no longer takes the "
                         "fallback path")
    except BddBlowupError:
        forest_s = time.perf_counter() - t0

    # The JAX package's own event-tree step, under default Settings.
    sequences = RiskAnalysis(model, settings)._analyze_event_tree(initiating)
    golden = {
        "model": [os.path.basename(path) for path in INPUTS],
        "initiating_event": initiating.name,
        "derivation": "canopy_tpu RiskAnalysis._analyze_event_tree "
                      "(default Settings), f64, JAX on the CPU; "
                      "tools/make_torch_event_tree_model.py",
        "n_basic": tree.n_basic,
        "n_gates": tree.n_gates,
        "n_sequences": len(sequences),
        "forest_max_nodes": FOREST_LIMIT,
        "forest_exceeds_max_nodes": True,
        "sequences": {s.sequence: s.probability for s in sequences},
        "fixtures": {name: fixture_values(name) for name in FIXTURE_NAMES},
        "sil_slice": sil_slice(),
    }
    with open(GOLDEN_PATH, "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(golden["sequences"].values())
    print(f"wrote {MODEL_PATH} and {GOLDEN_PATH}: {len(sequences)} "
          f"sequences summing to {total!r}; {tree.n_gates} gates; the "
          f"forest gave up at {FOREST_LIMIT} nodes after {forest_s:.1f} s")


if __name__ == "__main__":
    main()
