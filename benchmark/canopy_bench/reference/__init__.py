"""The plain reference: what an analysis of an Open-PSA MEF model should
report, worked out again from the model files and the seed.

It imports nothing of the program under test (nor JAX): its own MEF
reader (``mef.py``), its own BDD (``bdd.py``), the samples drawn as the
analysis keys them (``sampler.py``) and the reported statistics
(``stats.py``).  Each top's trials can be evaluated in a lower precision
than float64, which is how the control of ``correct`` is made.
"""

from __future__ import annotations

import numpy as np
import torch

from .bdd import build_bdd, evaluate
from .mef import read_model, reached_basic_events, top_events
from .sampler import lognormal_block, prng_key
from .stats import top_stats

__all__ = ["Reference"]


class Reference:
    def __init__(self, paths, device):
        self.model = read_model(paths)
        self.device = torch.device(device)
        self._tops: dict = {}

    def tops(self) -> list[tuple[str, str]]:
        return top_events(self.model)

    def _top(self, top: str):
        got = self._tops.get(top)
        if got is None:
            names = reached_basic_events(self.model, ("gate", top))
            bdd = build_bdd(self.model, top)
            column = {n: i for i, n in enumerate(names)}
            got = self._tops[top] = (bdd, names,
                                     [column[n] for n in bdd.order])
        return got

    def top_trials(self, top: str, seed: int, n_trials: int,
                   dtype=torch.float64) -> np.ndarray:
        """Each trial's top probability, the samples drawn under
        ``prng_key(seed)``."""
        bdd, names, columns = self._top(top)
        samples = lognormal_block([self.model.basic[n] for n in names],
                                  prng_key(seed), n_trials, self.device)
        tops = evaluate(bdd, samples, columns, dtype)
        del samples
        return tops.to(torch.float64).cpu().numpy()

    def top_uncertainty(self, top: str, seed: int, n_trials: int,
                        num_quantiles: int, num_bins: int,
                        dtype=torch.float64) -> dict:
        return top_stats(self.top_trials(top, seed, n_trials, dtype),
                         num_quantiles, num_bins)
