"""Analysis settings: the full configuration surface of a quantification run.

Capability parity with the reference ``Settings`` builder
(``reference/src/mef/openpsa/settings.h:13-332``), including its
order-dependent, mutually-constraining option semantics:

* ``algorithm`` resets the approximation default (BDD -> exact,
  MOCUS/ZBDD -> rare-event).
* ``prime_implicants`` requires BDD and cancels approximations.
* ``importance`` / ``uncertainty`` / ``safety_integrity_levels`` imply
  ``probability``; probability cannot be switched off while they are on.
* ``safety_integrity_levels`` requires a time step; the time step cannot be
  disabled while SIL is requested.

The fluent setters validate eagerly so analysis code never needs to re-check.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from .errors import SettingsError


class Algorithm(enum.IntEnum):
    """Qualitative analysis algorithms."""

    BDD = 0
    ZBDD = 1
    MOCUS = 2
    DIRECT = 3  # Direct propagation over the gate DAG ("pdag").


_ALGORITHM_NAMES = {"bdd": Algorithm.BDD, "zbdd": Algorithm.ZBDD,
                    "mocus": Algorithm.MOCUS, "pdag": Algorithm.DIRECT}


class Approximation(enum.IntEnum):
    """Quantitative analysis approximations."""

    NONE = 0
    RARE_EVENT = 1
    MCUB = 2
    MONTE_CARLO = 3


_APPROXIMATION_NAMES = {"none": Approximation.NONE,
                        "rare-event": Approximation.RARE_EVENT,
                        "mcub": Approximation.MCUB,
                        "monte-carlo": Approximation.MONTE_CARLO}


@dataclasses.dataclass
class Settings:
    """Quantification settings with fluent, constraint-checking setters.

    Defaults follow the reference (``settings.h:314-332``): mission time one
    year (8760 h), cut-off 1e-8, product order limit 20, 1000 MC trials.
    """

    _algorithm: Algorithm = Algorithm.BDD
    _approximation: Approximation = Approximation.NONE
    _probability_analysis: bool = False
    _safety_integrity_levels: bool = False
    _importance_analysis: bool = False
    _uncertainty_analysis: bool = False
    _ccf_analysis: bool = False
    _prime_implicants: bool = False
    _skip_products: bool = False
    _limit_order: int = 20
    _seed: int = 0
    _num_trials: int = 1000
    _batch_size: int = 1
    _sample_size: int = 1
    _num_quantiles: int = 20
    _num_bins: int = 20
    _mission_time: float = 8760.0
    _time_step: float = 0.0
    _cut_off: float = 1e-8
    preprocessor: bool = False
    print_results: bool = False

    # -- algorithm ---------------------------------------------------------
    def algorithm(self, value: Algorithm | str | None = None):
        if value is None:
            return self._algorithm
        if isinstance(value, str):
            try:
                value = _ALGORITHM_NAMES[value]
            except KeyError:
                raise SettingsError(
                    f"The qualitative analysis algorithm '{value}' is not recognized.")
        self._algorithm = Algorithm(value)
        # Appropriate defaults for the approximation follow the algorithm:
        # BDD-based analyses are exact; MOCUS/ZBDD default to rare-event.
        if value == Algorithm.BDD:
            self._approximation = Approximation.NONE
        elif self._approximation == Approximation.NONE:
            self._approximation = Approximation.RARE_EVENT
        if value != Algorithm.BDD:
            self._prime_implicants = False
        return self

    # -- approximation -----------------------------------------------------
    def approximation(self, value: Approximation | str | None = None):
        if value is None:
            return self._approximation
        if isinstance(value, str):
            try:
                value = _APPROXIMATION_NAMES[value]
            except KeyError:
                raise SettingsError(
                    f"The approximation '{value}' is not recognized.")
        value = Approximation(value)
        if value != Approximation.NONE and self._prime_implicants:
            raise SettingsError(
                "Approximations cannot be applied to prime implicant analysis.")
        self._approximation = value
        return self

    def prime_implicants(self, flag: bool | None = None):
        if flag is None:
            return self._prime_implicants
        if flag and self._algorithm != Algorithm.BDD:
            raise SettingsError(
                "Prime implicants can only be calculated with the BDD algorithm.")
        self._prime_implicants = bool(flag)
        if flag:
            # The request for prime implicants cancels approximations.
            self._approximation = Approximation.NONE
        return self

    # -- bounded numeric options ------------------------------------------
    def limit_order(self, order: int | None = None):
        if order is None:
            return self._limit_order
        if order < 0:
            raise SettingsError(
                f"The limit on the order of products cannot be negative: {order}")
        self._limit_order = int(order)
        return self

    def cut_off(self, prob: float | None = None):
        if prob is None:
            return self._cut_off
        if not (0.0 <= prob <= 1.0) or math.isnan(prob):
            raise SettingsError(
                f"The cut-off probability must be in [0, 1]: {prob}")
        self._cut_off = float(prob)
        return self

    def num_trials(self, n: int | None = None):
        if n is None:
            return self._num_trials
        if n < 1:
            raise SettingsError(
                f"The number of Monte-Carlo trials must be positive: {n}")
        self._num_trials = int(n)
        return self

    def batch_size(self, n: int | None = None):
        if n is None:
            return self._batch_size
        if n < 1:
            raise SettingsError(f"The batch size must be positive: {n}")
        self._batch_size = int(n)
        return self

    def sample_size(self, n: int | None = None):
        if n is None:
            return self._sample_size
        if n < 1:
            raise SettingsError(f"The sample size must be positive: {n}")
        self._sample_size = int(n)
        return self

    def num_quantiles(self, n: int | None = None):
        if n is None:
            return self._num_quantiles
        if n < 1:
            raise SettingsError(f"The number of quantiles must be positive: {n}")
        self._num_quantiles = int(n)
        return self

    def num_bins(self, n: int | None = None):
        if n is None:
            return self._num_bins
        if n < 1:
            raise SettingsError(f"The number of bins must be positive: {n}")
        self._num_bins = int(n)
        return self

    def seed(self, s: int | None = None):
        if s is None:
            return self._seed
        if s < 0:
            raise SettingsError(f"The seed cannot be negative: {s}")
        self._seed = int(s)
        return self

    def mission_time(self, time: float | None = None):
        if time is None:
            return self._mission_time
        if time < 0:
            raise SettingsError(f"The mission time cannot be negative: {time}")
        self._mission_time = float(time)
        return self

    def time_step(self, time: float | None = None):
        if time is None:
            return self._time_step
        if time < 0:
            raise SettingsError(f"The time step cannot be negative: {time}")
        if time == 0 and self._safety_integrity_levels:
            raise SettingsError(
                "The time step cannot be disabled while SIL metrics are requested.")
        self._time_step = float(time)
        return self

    # -- analysis toggles (with implication rules) -------------------------
    def probability_analysis(self, flag: bool | None = None):
        if flag is None:
            return self._probability_analysis
        # Cannot be turned off while a dependent analysis is requested.
        if not (self._importance_analysis or self._uncertainty_analysis
                or self._safety_integrity_levels):
            self._probability_analysis = bool(flag)
        return self

    def safety_integrity_levels(self, flag: bool | None = None):
        if flag is None:
            return self._safety_integrity_levels
        if flag and self._time_step == 0:
            raise SettingsError(
                "SIL metrics require a time step to be set.")
        self._safety_integrity_levels = bool(flag)
        if flag:
            self._probability_analysis = True
        return self

    def importance_analysis(self, flag: bool | None = None):
        if flag is None:
            return self._importance_analysis
        self._importance_analysis = bool(flag)
        if flag:
            self._probability_analysis = True
        return self

    def uncertainty_analysis(self, flag: bool | None = None):
        if flag is None:
            return self._uncertainty_analysis
        self._uncertainty_analysis = bool(flag)
        if flag:
            self._probability_analysis = True
        return self

    def ccf_analysis(self, flag: bool | None = None):
        if flag is None:
            return self._ccf_analysis
        self._ccf_analysis = bool(flag)
        return self

    def skip_products(self, flag: bool | None = None):
        if flag is None:
            return self._skip_products
        self._skip_products = bool(flag)
        return self

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "algorithm": self._algorithm.name.lower(),
            "approximation": self._approximation.name.lower().replace("_", "-"),
            "probability_analysis": self._probability_analysis,
            "safety_integrity_levels": self._safety_integrity_levels,
            "importance_analysis": self._importance_analysis,
            "uncertainty_analysis": self._uncertainty_analysis,
            "ccf_analysis": self._ccf_analysis,
            "prime_implicants": self._prime_implicants,
            "skip_products": self._skip_products,
            "limit_order": self._limit_order,
            "seed": self._seed,
            "num_trials": self._num_trials,
            "batch_size": self._batch_size,
            "sample_size": self._sample_size,
            "num_quantiles": self._num_quantiles,
            "num_bins": self._num_bins,
            "mission_time": self._mission_time,
            "time_step": self._time_step,
            "cut_off": self._cut_off,
        }
