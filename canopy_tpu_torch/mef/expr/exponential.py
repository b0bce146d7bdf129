"""Exponential-family life distributions (reference ``expr/exponential.h``).

The reference declares these classes but never committed their math
(SURVEY.md §0.1); the formulas here are re-derived from the standard
SCRAM/Open-PSA MEF semantics:

* ``Exponential(lambda, t)``: P(failure by t) = 1 - exp(-lambda*t).
* ``Glm(gamma, lambda, mu, t)``: repairable component with failure rate
  lambda, repair rate mu and probability of failure on demand gamma::

      r = lambda + mu
      p(t) = (lambda - (lambda - gamma*r) * exp(-r*t)) / r

  which satisfies p(0) = gamma and p(inf) = lambda/(lambda+mu).
* ``Weibull(alpha, beta, t0, t)``: P = 1 - exp(-((t-t0)/alpha)^beta) for
  t > t0, else 0 (alpha = scale, beta = shape, t0 = shift).
* ``PeriodicTest``: unavailability of a periodically tested component, in
  the three MEF flavors (4, 5, and 11 arguments). The 5/11-argument
  flavors are computed with an exact piecewise-constant Markov propagation
  (closed-form matrix exponential per inter-test segment) over the states
  {Operating, Failed-latent, Under-repair}; see the flavor docstrings.
"""

from __future__ import annotations

import math

from ...errors import ValidityError
from ..expression import (Expression, Interval, corner_interval,
                          ensure_non_negative, ensure_positive,
                          ensure_probability)


class Exponential(Expression):
    """P = 1 - exp(-lambda * t)."""

    tape_op = "exponential"

    def __init__(self, lambda_: Expression, time: Expression):
        super().__init__([lambda_, time])

    def _compute(self, lambda_, time):
        return -math.expm1(-lambda_ * time)

    def validate(self) -> None:
        ensure_non_negative(self.args[0], "rate of failure")
        ensure_non_negative(self.args[1], "mission time")

    def interval(self) -> Interval:
        return corner_interval(self._compute, [a.interval() for a in self.args])


class Glm(Expression):
    """The General Linear Model unavailability for repairable components."""

    tape_op = "glm"

    def __init__(self, gamma: Expression, lambda_: Expression, mu: Expression,
                 time: Expression):
        super().__init__([gamma, lambda_, mu, time])

    def _compute(self, gamma, lambda_, mu, time):
        r = lambda_ + mu
        if r == 0:
            return gamma
        return (lambda_ - (lambda_ - gamma * r) * math.exp(-r * time)) / r

    def validate(self) -> None:
        gamma, lambda_, mu, time = self.args
        ensure_probability(gamma, "failure on demand probability")
        ensure_positive(lambda_, "rate of failure")
        ensure_non_negative(mu, "rate of repair")
        ensure_non_negative(time, "mission time")


class Weibull(Expression):
    """P = 1 - exp(-((t - t0)/alpha)^beta) for t > t0."""

    tape_op = "weibull"

    def __init__(self, alpha: Expression, beta: Expression, t0: Expression,
                 time: Expression):
        super().__init__([alpha, beta, t0, time])

    def _compute(self, alpha, beta, t0, time):
        if time <= t0:
            return 0.0
        return -math.expm1(-(((time - t0) / alpha) ** beta))

    def validate(self) -> None:
        alpha, beta, t0, time = self.args
        ensure_positive(alpha, "scale parameter for Weibull distribution")
        ensure_positive(beta, "shape parameter for Weibull distribution")
        ensure_non_negative(t0, "time shift")
        ensure_non_negative(time, "mission time")


# ---------------------------------------------------------------------------
# Periodic test.
# ---------------------------------------------------------------------------

def _instant_repair(lambda_, tau, theta, time):
    """Flavor 1 (4 args): instant, perfect test and repair.

    The component is as-new after every test; unavailability is the
    probability of failure since the last test (or since 0 before the
    first test at ``theta``).
    """
    if time <= theta:
        delta = time
    else:
        delta = math.fmod(time - theta, tau)
    return -math.expm1(-lambda_ * delta)


def _propagate_segment(op, lat, rep, lambda_, mu, dt):
    """Closed-form propagation of (Operating, Latent, Repair) over dt.

    ODE between tests: Op' = -lambda*Op + mu*Rep; Rep' = -mu*Rep;
    Lat' = lambda*Op. Solved exactly for constant coefficients.
    """
    if dt <= 0:
        return op, lat, rep
    e_l = math.exp(-lambda_ * dt)
    e_m = math.exp(-mu * dt)
    if abs(mu - lambda_) > 1e-12 * max(mu, lambda_, 1.0):
        op_new = op * e_l + mu * rep * (e_l - e_m) / (mu - lambda_)
    else:  # Degenerate equal-rate case.
        op_new = op * e_l + mu * rep * dt * e_l
    rep_new = rep * e_m
    lat_new = 1.0 - op_new - rep_new - (1.0 - op - lat - rep)
    return op_new, lat_new, rep_new


def _instant_test(lambda_, mu, tau, theta, time):
    """Flavor 2 (5 args): instant test, exponential repair with rate mu.

    Failures are latent (undetected) between tests; each test instantly
    detects all latent failures, which then repair with rate ``mu``.
    Unavailability = P(latent) + P(under repair).
    """
    op, lat, rep = 1.0, 0.0, 0.0
    t = 0.0
    next_test = theta
    while next_test < time:
        op, lat, rep = _propagate_segment(op, lat, rep, lambda_, mu,
                                          next_test - t)
        t = next_test
        rep += lat  # Test: all latent failures detected -> repair.
        lat = 0.0
        next_test += tau
    op, lat, rep = _propagate_segment(op, lat, rep, lambda_, mu, time - t)
    return lat + rep


def _complete(lambda_, lambda_test, mu, tau, theta, gamma, test_duration,
              available_at_test, sigma, omega, time):
    """Flavor 3 (11 args): the full MEF periodic-test model.

    Parameters follow the Open-PSA MEF: ``lambda`` failure rate in
    operation, ``lambda_test`` failure rate during test windows, ``mu``
    repair rate, ``tau``/``theta`` test period and first-test time,
    ``gamma`` probability that the test itself causes a (detected)
    failure, ``test_duration`` length of the test window,
    ``available_at_test`` whether the component can operate during its
    test, ``sigma`` test coverage (probability a latent failure is
    detected), ``omega`` probability the component is left failed
    (latent) after a test.
    """
    op, lat, rep = 1.0, 0.0, 0.0
    t = 0.0
    next_test = theta
    in_window_unavailable = 0.0
    while next_test < time:
        op, lat, rep = _propagate_segment(op, lat, rep, lambda_, mu,
                                          next_test - t)
        t = next_test
        # Test instant: coverage sigma detects latent failures; the test
        # itself breaks an operating component with probability gamma and
        # leaves it failed-latent with probability omega.
        detected = sigma * lat
        caused = gamma * op
        left_failed = omega * (op - caused)
        rep += detected + caused
        lat = lat - detected + left_failed
        op = op - caused - left_failed
        # Test window with modified failure rate.
        window_end = min(t + test_duration, time)
        op, lat, rep = _propagate_segment(op, lat, rep, lambda_test, mu,
                                          window_end - t)
        if not available_at_test and window_end > t:
            # The whole window counts as unavailable if it covers `time`.
            if window_end >= time:
                return 1.0
        t = window_end
        next_test += tau
    op, lat, rep = _propagate_segment(op, lat, rep, lambda_, mu, time - t)
    return lat + rep + in_window_unavailable


class PeriodicTest(Expression):
    """Unavailability of a periodically tested component (3 flavors)."""

    tape_op = "periodic-test"

    def __init__(self, *args: Expression):
        if len(args) not in (4, 5, 11):
            raise ValidityError(
                "Invalid number of arguments for the periodic-test "
                f"expression: {len(args)} (expected 4, 5, or 11).")
        super().__init__(args)

    def _compute(self, *values):
        if len(values) == 4:
            return _instant_repair(*values)
        if len(values) == 5:
            return _instant_test(*values)
        (lambda_, lambda_test, mu, tau, theta, gamma, test_duration,
         available_at_test, sigma, omega, time) = values
        return _complete(lambda_, lambda_test, mu, tau, theta, gamma,
                         test_duration, bool(available_at_test), sigma, omega,
                         time)

    def validate(self) -> None:
        n = len(self.args)
        if n == 4:
            lambda_, tau, theta, time = self.args
            ensure_non_negative(lambda_, "rate of failure")
            ensure_positive(tau, "time between tests")
            ensure_non_negative(theta, "time before tests")
            ensure_non_negative(time, "mission time")
        elif n == 5:
            lambda_, mu, tau, theta, time = self.args
            ensure_non_negative(lambda_, "rate of failure")
            ensure_non_negative(mu, "rate of repair")
            ensure_positive(tau, "time between tests")
            ensure_non_negative(theta, "time before tests")
            ensure_non_negative(time, "mission time")
        else:
            (lambda_, lambda_test, mu, tau, theta, gamma, test_duration,
             _available, sigma, omega, time) = self.args
            ensure_non_negative(lambda_, "rate of failure")
            ensure_non_negative(lambda_test, "rate of failure while tested")
            ensure_non_negative(mu, "rate of repair")
            ensure_positive(tau, "time between tests")
            ensure_non_negative(theta, "time before tests")
            ensure_probability(gamma, "failure at test start probability")
            ensure_non_negative(test_duration, "test duration")
            ensure_probability(sigma, "test coverage")
            ensure_probability(omega, "post-test failure probability")
            ensure_non_negative(time, "mission time")

    def interval(self) -> Interval:
        return Interval.closed(0.0, 1.0)
