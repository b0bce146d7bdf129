"""Torch port, ``sparse_lu`` on ``tests/test_markov.py``'s 2,000-row
diagonally dominant matrix, against scipy's ``splu`` at that test's
tolerances (1e-8 relative, 1e-10 absolute).

A file of its own: the host factorization (the JAX package's, copied)
takes minutes on this matrix's fill, and a file runs on one worker.
"""

import numpy as np
import torch

from canopy_tpu_torch.ops.markov import sparse_lu
from test_torch_markov import _dd_matrix


def test_solve_vs_scipy_splu():
    from scipy.sparse.linalg import splu
    n = 2_000
    sp, _A = _dd_matrix(n, 4.0 / n, seed=2)
    lu = sparse_lu(sp.indptr, sp.indices, sp.data, n,
                   device=torch.device("cpu"))
    b = np.random.default_rng(4).uniform(-1, 1, n)
    expected = splu(sp.tocsc(), permc_spec="NATURAL",
                    options={"SymmetricMode": False}).solve(b)
    got = lu.solve(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-8, atol=1e-10)
