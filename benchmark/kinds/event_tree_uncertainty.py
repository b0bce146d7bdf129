"""Request kind ``event_tree_uncertainty``: every sequence of an event
tree quantified under parameter uncertainty, against a tree compiled once.

Set-up parses the configuration's model files and compiles its initiating
event's event tree once (``engine.sequences.compile_event_tree``: the
walk, the multi-root compile, the forest attempt and its fallback, as
``RiskAnalysis`` does); each request is one
``engine.sequences.sequence_uncertainty`` call on it, every sequence over
``n_trials`` trials drawn under the request's seed.

Mix keys: ``log2_trials``, the request sizes of one round as powers of
two (a size listed twice is sent twice a round).

The judge's numbers:

* ``stat_gap``: the largest relative gap, over every sequence, of its
  mean, standard deviation, error factor and both ends of its 95 %
  interval (two infinite error factors are no gap);
* ``method_mismatch``: the number of sequences with a path formula whose
  method is not the configuration's ``sequence_method``.

The program is imported inside the class, so that the harness can set
its environment first; the reference never is.
"""

from __future__ import annotations

import torch

from canopy_bench import judge

MIX_KEYS = ("log2_trials",)

#: The control's precision: the nearest below the one a result is stated
#: in.
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}
STATS = ("mean", "std", "error_factor")


def round_shapes(mix: dict) -> list[dict]:
    return [{"n_trials": 1 << int(k)} for k in mix["log2_trials"]]


def work(request: dict) -> int:
    return request["n_trials"]


def label(request: dict) -> str:
    return f"bench.request.n{request['n_trials']}"


def reference(paths, device):
    from canopy_bench.reference.event_tree import EventTreeReference
    return EventTreeReference(paths, device)


def sequence_gap(got: dict | None, want: dict) -> float:
    """The worst relative gap of one sequence's statistics."""
    if got is None or got.get("sequence") != want["sequence"] or \
            got.get("n_trials") != want["n_trials"]:
        return judge.INF
    gaps = [judge.rel(got[k], want[k]) for k in STATS]
    gaps += [judge.rel(a, b) for a, b in zip(got["ci95"], want["ci95"])]
    return max(gaps)


class Cell:
    def __init__(self, config: dict, mix: dict, device, paths: list):
        self.config = config
        self.mix = mix
        self.device = device
        self.paths = paths
        self.compiled = None

    def setup(self) -> None:
        from canopy_tpu_torch.engine.sequences import compile_event_tree
        from canopy_tpu_torch.mef import Initializer
        from canopy_tpu_torch.settings import Settings

        settings = Settings()
        model = Initializer(self.paths, settings).model
        (initiating,) = [ie for ie in model.initiating_events
                         if ie.name == self.config["initiating_event"]]
        self.compiled = compile_event_tree(model, initiating, settings,
                                           self.device)

    def run(self, request: dict) -> dict:
        from canopy_tpu_torch.engine.sequences import sequence_uncertainty
        out = sequence_uncertainty(self.compiled, request["seed"],
                                   request["n_trials"])
        return {**request, "sequences": [
            {"sequence": outcome.sequence.name, **out[k]}
            for k, outcome in enumerate(self.compiled.outcomes)]}

    def free(self) -> None:
        self.compiled = None

    def judge(self, records: list, reference, control: bool = False
              ) -> dict:
        """Worst gaps over ``records``; with ``control`` the reference in
        the stated precision's lower neighbour stands in the program's
        place."""
        lower = LOWER[self.config["precision"]["sequence_trials"]]
        method = self.config["sequence_method"]
        gated = [bool(o.formulas) for o in reference.outcomes]
        numbers: dict = {}
        for rec in records:
            want = reference.sequence_uncertainty(rec["seed"],
                                                  rec["n_trials"])
            if control:
                got = [{**s, "method": method} for s in
                       reference.sequence_uncertainty(
                           rec["seed"], rec["n_trials"], lower)]
            else:
                got = rec["sequences"]
            if len(got) != len(want):
                judge.worst(numbers, "stat_gap", judge.INF)
                judge.worst(numbers, "method_mismatch", judge.INF)
                continue
            judge.worst(numbers, "stat_gap", max(
                sequence_gap(g, w) for g, w in zip(got, want)))
            judge.worst(numbers, "method_mismatch", float(sum(
                1 for g, is_gated in zip(got, gated)
                if is_gated and g.get("method") != method)))
        return numbers
