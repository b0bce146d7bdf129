"""Quantification engines on torch: gather propagation, exact BDD, analysis."""

from .propagate import (propagate_probability,  # noqa: F401
                        top_event_probability)
from .analysis import Report, RiskAnalysis  # noqa: F401
