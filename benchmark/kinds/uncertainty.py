"""Request kind ``uncertainty``: uncertainty requests against a model
compiled once.

Set-up parses and compiles the configuration's model once, as
``RiskAnalysis._analyze_top`` does (the compiled tree, the expression
tape, the modular BDD, its evaluator); each request is one
``engine.uncertainty.uncertainty_analysis`` call on it, of ``n_trials``
trials drawn under the request's seed.

Mix keys: ``log2_trials``, the request sizes of one round as powers of
two (a size listed twice is sent twice a round).

The program is imported inside the class, so that the harness can set
its environment first; the reference never is.
"""

from __future__ import annotations

import types

import torch

from canopy_bench import judge

MIX_KEYS = ("log2_trials",)

#: The control's precision: the nearest below the one a result is stated
#: in.
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def round_shapes(mix: dict) -> list[dict]:
    return [{"n_trials": 1 << int(k)} for k in mix["log2_trials"]]


def work(request: dict) -> int:
    return request["n_trials"]


def label(request: dict) -> str:
    return f"bench.request.n{request['n_trials']}"


def _stats(result) -> dict:
    return {"mean": result.mean, "std": result.std,
            "error_factor": result.error_factor,
            "ci95": list(result.confidence_interval(0.95)),
            "n_trials": result.n_trials,
            "quantiles": result.quantiles.tolist(),
            "histogram_edges": result.histogram_edges.tolist(),
            "histogram_density": result.histogram_density.tolist()}


class Cell:
    def __init__(self, config: dict, mix: dict, device, paths: list):
        self.config = config
        self.mix = mix
        self.device = device
        self.paths = paths

    def setup(self) -> None:
        from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
        from canopy_tpu_torch.compiler.graph import compile_fault_tree
        from canopy_tpu_torch.compiler.modules import build_modular_bdd
        from canopy_tpu_torch.engine.bdd_eval import make_modular_evaluator
        from canopy_tpu_torch.mef import Initializer
        from canopy_tpu_torch.settings import Settings

        settings = Settings()
        model = Initializer(self.paths, settings).model
        top = None
        for fault_tree in model.fault_trees:
            if not fault_tree.top_events:
                fault_tree.collect_top_events()
            for gate in fault_tree.top_events:
                if gate.id == self.config["top"]:
                    top, tree_name = gate, fault_tree.name
        view = types.SimpleNamespace(name=tree_name, top_events=[top])
        self.tree = compile_fault_tree(view, top)
        self.mission = settings.mission_time()
        model.mission_time.set_value(self.mission)
        self.tape = ExpressionTape.build(
            [e.expression for e in self.tree.basic_events])
        modular = build_modular_bdd(
            self.tree, house_states=self.tree.house_state_vector())
        self.evaluator = make_modular_evaluator(modular, self.device)

    def run(self, request: dict) -> dict:
        from canopy_tpu_torch.engine.uncertainty import uncertainty_analysis
        result = uncertainty_analysis(
            self.tree, self.tape, request["seed"], request["n_trials"],
            self.mission, self.device,
            num_quantiles=self.config["num_quantiles"],
            num_bins=self.config["num_bins"], top_fn=self.evaluator)
        return {**request, "uncertainty": _stats(result)}

    def free(self) -> None:
        self.tree = self.tape = self.evaluator = None

    def judge(self, records: list, reference, control: bool = False
              ) -> dict:
        """Worst gaps over ``records``; with ``control`` the reference in
        the stated precision's lower neighbour stands in the program's
        place."""
        top = self.config["top"]
        lower = LOWER[self.config["precision"]["top_trials"]]
        shape = (self.config["num_quantiles"], self.config["num_bins"])
        numbers: dict = {}
        for rec in records:
            ref = reference.top_uncertainty(top, rec["seed"],
                                            rec["n_trials"], *shape)
            got = reference.top_uncertainty(
                top, rec["seed"], rec["n_trials"], *shape, lower) \
                if control else rec["uncertainty"]
            judge.worst(numbers, "stat_gap", judge.stat_gap(got, ref))
            judge.worst(numbers, "hist_moved", judge.hist_moved(got, ref))
        return numbers
