"""``engine.uncertainty.summarize`` against NumPy on the host.

The statistics reduce on the tops' own device from one sort; on a CPU
tensor that is the host.  Quantiles, median, the 95th percentile and the
histogram must equal ``np.quantile``, ``np.median`` and
``np.histogram(density=True)`` on the same values to the bit, in float64
and in float32 (where NumPy takes the 95th percentile's level, the edges
and the median in float32); mean and ``std(ddof=1)`` accumulate in float64
and hold to NumPy's float64 results on the same values within 1e-12.
"""

import numpy as np
import pytest
import torch

from canopy_tpu_torch.engine.uncertainty import summarize


def _values(case: str) -> np.ndarray:
    rng = np.random.default_rng(16)
    return {
        "lognormal": lambda: rng.lognormal(-9.0, 1.1, 4096),
        "odd": lambda: rng.lognormal(-5.0, 0.7, 3 * (1 << 12) + 7),
        "uniform": lambda: rng.random(1001),
        "ties": lambda: rng.integers(0, 6, 2000) * 0.125,
        "signed": lambda: rng.normal(0.0, 1e3, 777),
        "all_equal": lambda: np.full(500, 0.3),
        "two": lambda: np.array([2e-3, 7e-4]),
        # Levels 0.25 and 0.75 of 3 values: weights of exactly 0.5.
        "half_weights": lambda: np.array([0.5, 0.1, 0.9]),
    }[case]()


CASES = [("lognormal", 20, 20), ("odd", 20, 20), ("uniform", 11, 7),
         ("ties", 20, 20), ("signed", 5, 3), ("all_equal", 20, 20),
         ("two", 20, 20), ("half_weights", 5, 1)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case,num_quantiles,num_bins", CASES)
def test_summarize_matches_numpy(case, num_quantiles, num_bins, dtype):
    x = _values(case).astype(dtype)
    got = summarize(torch.from_numpy(x.copy()), num_quantiles, num_bins)

    quantiles = np.quantile(x, np.linspace(0.0, 1.0, num_quantiles))
    median = float(np.median(x))
    p95 = float(np.quantile(x, 0.95))
    density, edges = np.histogram(x, bins=num_bins, density=True)
    assert got.n_trials == x.size
    assert got.quantiles.dtype == quantiles.dtype
    assert np.array_equal(got.quantiles, quantiles)
    assert got.error_factor == (p95 / median if median > 0
                                else float("inf"))
    assert got.histogram_edges.dtype == edges.dtype
    assert np.array_equal(got.histogram_edges, edges)
    assert got.histogram_density.dtype == density.dtype
    assert np.array_equal(got.histogram_density, density)
    wide = x.astype(np.float64)
    scale = abs(wide.mean()) + wide.std(ddof=1)
    assert abs(got.mean - wide.mean()) <= 1e-12 * scale
    assert abs(got.std - wide.std(ddof=1)) <= 1e-12 * scale


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_summarize_refuses_a_range_that_is_not_finite(bad):
    x = torch.tensor([0.1, bad, 0.2], dtype=torch.float64)
    with pytest.raises(ValueError, match="not finite"):
        summarize(x)
    with pytest.raises(ValueError, match="not finite"):
        np.histogram(x.numpy(), bins=20)
