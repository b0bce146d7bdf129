"""Torch port, Markov submodels (``ops/markov.py``) on the CPU.

Every case of ``tests/test_markov.py`` through the port, against the same
scipy/numpy oracles at the same tolerances (the 2,000-row ``sparse_lu``
case is in ``test_torch_markov_lu.py``, its host factorization alone
takes minutes), and the JAX package against the port on the same numpy
inputs:

* transients within 1e-12 absolute;
* blocked triangular and ``sparse_lu`` solves within 1e-12 relative
  (elementwise, plus 1e-15 of the largest entry), the host-compiled
  programs and factors equal array for array;
* ``markov_stationary``, dense and sparse, within 1e-12 absolute;
* the ``LogicError`` cases raise in both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canopy_tpu.ops.markov as jm
import canopy_tpu_torch.ops.markov as tm
from canopy_tpu.errors import LogicError as JaxLogicError
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.utils.markov_models import (birth_death_csr,
                                                  random_lower_csr,
                                                  repairable_components)

CPU = torch.device("cpu")


def two_state_generator(lam, mu):
    """Up/down repairable component: up -> down rate lam, down -> up mu."""
    return torch.tensor([[-lam, lam], [mu, -mu]], dtype=torch.float64)


def assert_rel(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-15 * np.abs(want).max())


def _random_lower(n, density, seed, chain=False):
    """``tests/test_markov.py``'s generator: strictly-lower CSR, diag and
    the dense lower part."""
    from scipy.sparse import csr_matrix
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    dense = np.tril(rng.uniform(0.1, 1.0, (n, n)) * mask, k=-1)
    if chain:
        for i in range(1, n):
            dense[i, i - 1] = rng.uniform(0.5, 1.0)
    diag = rng.uniform(0.5, 2.0, n)
    return csr_matrix(dense), diag, dense


def _dd_matrix(n, density, seed):
    """Sparse strictly diagonally dominant matrix (CSR) and its dense
    form (``tests/test_markov.py``'s)."""
    from scipy.sparse import csr_matrix
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, n)) < density) & ~np.eye(n, dtype=bool)
    A = rng.uniform(-1.0, 1.0, (n, n)) * mask
    np.fill_diagonal(A, np.abs(A).sum(axis=1) + 1.0)
    return csr_matrix(A), A


def _birth_death(n, seed=0):
    """``tests/test_markov.py``'s dense birth-death chain with jumps."""
    rng = np.random.default_rng(seed)
    Q = np.zeros((n, n))
    for i in range(n - 1):
        Q[i, i + 1] = rng.uniform(0.5, 1.5)
    for i in range(1, n):
        Q[i, i - 1] = rng.uniform(0.5, 1.5)
    for _ in range(n // 50):
        i, j = rng.integers(0, n, 2)
        if i != j:
            Q[i, j] += rng.uniform(0.1, 0.5)
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    return Q


# ---------------------------------------------------------------------------
# tests/test_markov.py through the port.


class TestTransient:
    def test_matches_glm_closed_form(self):
        lam, mu, t = 1e-2, 1e-1, 37.0
        p = tm.markov_transient(two_state_generator(lam, mu),
                                torch.tensor([1.0, 0.0]), t)
        r = lam + mu
        expected_down = (lam - lam * math.exp(-r * t)) / r
        assert abs(float(p[1]) - expected_down) < 1e-12
        assert abs(float(p.sum()) - 1.0) < 1e-12

    def test_three_state_chain_vs_expm(self):
        from scipy.linalg import expm
        rng = np.random.default_rng(0)
        A = rng.uniform(0.0, 0.5, (4, 4))
        np.fill_diagonal(A, 0.0)
        Q = A - np.diag(A.sum(axis=1))
        t = 2.5
        p0 = np.array([1.0, 0.0, 0.0, 0.0])
        got = tm.markov_transient(Q, p0, t, device=CPU)
        np.testing.assert_allclose(got.numpy(), p0 @ expm(Q * t),
                                   atol=1e-10)

    def test_batched_initial_states(self):
        Q = two_state_generator(1e-3, 1e-2)
        p0 = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]],
                          dtype=torch.float64)
        out = tm.markov_transient(Q, p0, 100.0)
        assert out.shape == (3, 2)
        np.testing.assert_allclose(out.sum(dim=-1).numpy(), 1.0,
                                   atol=1e-12)

    def test_zero_generator(self):
        p0 = torch.tensor([0.3, 0.7], dtype=torch.float64)
        out = tm.markov_transient(torch.zeros((2, 2), dtype=torch.float64),
                                  p0, 10.0)
        np.testing.assert_allclose(out.numpy(), p0.numpy())


class TestStationary:
    def test_two_state(self):
        lam, mu = 1e-2, 1e-1
        pi = tm.markov_stationary(two_state_generator(lam, mu))
        r = lam + mu
        np.testing.assert_allclose(pi.numpy(), [mu / r, lam / r],
                                   atol=1e-12)


class TestTriangularSolve:
    def test_matches_scipy(self):
        from scipy.sparse import csr_matrix
        from scipy.sparse.linalg import spsolve_triangular
        rng = np.random.default_rng(1)
        n = 30
        dense = np.tril(rng.uniform(0.1, 1.0, (n, n)) *
                        (rng.random((n, n)) < 0.3), k=-1)
        diag = rng.uniform(0.5, 2.0, n)
        b = rng.uniform(-1, 1, n)
        expected = spsolve_triangular(csr_matrix(dense + np.diag(diag)), b,
                                      lower=True)
        strict = csr_matrix(dense)
        got = tm.triangular_solve_levels(
            strict.indptr, strict.indices, torch.from_numpy(strict.data),
            torch.from_numpy(diag), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), expected, atol=1e-10)


class TestBlockedTriangular:
    def test_lower_10k_vs_scipy(self):
        from scipy.sparse import csr_matrix, diags
        from scipy.sparse.linalg import spsolve_triangular
        n = 10_000
        indptr, indices, data, diag = random_lower_csr(n, 3.0 / n, seed=0,
                                                       chain=True)
        bt = tm.compile_blocked_triangular(indptr, indices, data, diag,
                                           lower=True, device=CPU)
        b = np.random.default_rng(3).uniform(-1, 1, n)
        full = csr_matrix((data, indices, indptr), shape=(n, n)) + \
            diags(diag)
        expected = spsolve_triangular(full.tocsr(), b, lower=True)
        got = bt.solve(torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-9, atol=1e-9)

    def test_upper_and_batched(self):
        from scipy.sparse import csr_matrix
        from scipy.sparse.linalg import spsolve_triangular
        n = 700
        _strict, diag, dense = _random_lower(n, 0.01, seed=5)
        upper = csr_matrix(dense.T)
        bt = tm.compile_blocked_triangular(upper.indptr, upper.indices,
                                           upper.data, diag, lower=False,
                                           block=64, device=CPU)
        b = np.random.default_rng(7).uniform(-1, 1, (4, n))
        full = csr_matrix(dense.T + np.diag(diag))
        expected = np.stack([spsolve_triangular(full, row, lower=False)
                             for row in b])
        got = bt.solve(torch.from_numpy(b)).numpy()
        assert got.shape == (4, n)
        np.testing.assert_allclose(got, expected, rtol=1e-9, atol=1e-9)

    def test_rejects_nontriangular_and_zero_diag(self):
        from scipy.sparse import csr_matrix
        bad = csr_matrix(np.triu(np.ones((4, 4)), k=1))
        with pytest.raises(LogicError):
            tm.compile_blocked_triangular(bad.indptr, bad.indices, bad.data,
                                          np.ones(4), lower=True,
                                          device=CPU)
        empty = csr_matrix(np.zeros((4, 4)))
        with pytest.raises(LogicError):
            tm.compile_blocked_triangular(empty.indptr, empty.indices,
                                          empty.data, np.zeros(4),
                                          device=CPU)


class TestSparseLU:
    def test_batched_rhs(self):
        n = 300
        sp, A = _dd_matrix(n, 0.02, seed=9)
        lu = tm.sparse_lu(sp.indptr, sp.indices, sp.data, n, device=CPU)
        b = np.random.default_rng(1).uniform(-1, 1, (3, n))
        got = lu.solve(torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, np.linalg.solve(A, b.T).T,
                                   rtol=1e-8, atol=1e-10)

    def test_singular_raises(self):
        from scipy.sparse import csr_matrix
        A = csr_matrix(np.array([[1.0, 2.0], [2.0, 4.0]]))
        with pytest.raises(LogicError):
            tm.sparse_lu(A.indptr, A.indices, A.data, 2, device=CPU)


class TestStationarySparse:
    def test_sparse_matches_dense_path(self):
        Q = _birth_death(300)
        pi_dense = tm.markov_stationary(Q, method="dense",
                                        device=CPU).numpy()
        pi_sparse = tm.markov_stationary(Q, method="sparse",
                                         device=CPU).numpy()
        np.testing.assert_allclose(pi_sparse, pi_dense, rtol=1e-8,
                                   atol=1e-12)
        assert abs(pi_sparse.sum() - 1.0) < 1e-9

    def test_csr_input_10k_states(self):
        sp = birth_death_csr(10_000, seed=3)
        pi = tm.markov_stationary((sp.indptr, sp.indices, sp.data),
                                  method="sparse", device=CPU).numpy()
        assert abs(pi.sum() - 1.0) < 1e-8
        assert np.abs(pi @ sp).max() < 1e-10    # Stationarity: pi Q = 0.
        assert (pi > 0).all()


# ---------------------------------------------------------------------------
# The JAX package against the port on the same numpy inputs.


def test_generators_are_the_dense_ones():
    """``random_lower_csr`` draws what ``_random_lower`` draws."""
    strict, diag, _dense = _random_lower(500, 0.02, seed=4, chain=True)
    indptr, indices, data, diag2 = random_lower_csr(500, 0.02, seed=4,
                                                    chain=True,
                                                    rows_per_chunk=37)
    for got, want in [(indptr, strict.indptr), (indices, strict.indices),
                      (data, strict.data), (diag2, diag)]:
        np.testing.assert_array_equal(got, want)
    q = repairable_components(4, seed=1)
    assert q.shape == (16, 16)
    np.testing.assert_allclose(q.sum(axis=1), 0.0, atol=1e-15)


@pytest.mark.parametrize("batch", [(), (5,)])
def test_transient_matches_jax(batch):
    Q = repairable_components(4, seed=2)
    rng = np.random.default_rng(3)
    p0 = rng.random(batch + (16,))
    p0 /= p0.sum(axis=-1, keepdims=True)
    for t in (0.5, 40.0):
        want = np.asarray(jm.markov_transient(jnp.asarray(Q),
                                              jnp.asarray(p0), t))
        got = tm.markov_transient(Q, p0, t, device=CPU).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("lower,batch", [(True, ()), (False, (2, 3))])
def test_blocked_solve_matches_jax(lower, batch):
    from scipy.sparse import csr_matrix
    n = 700
    strict, diag, dense = _random_lower(n, 0.01, seed=5, chain=True)
    if not lower:
        strict = csr_matrix(dense.T)
    args = (strict.indptr, strict.indices, strict.data, diag)
    jt = jm.compile_blocked_triangular(*args, lower=lower, block=64)
    tt = tm.compile_blocked_triangular(*args, lower=lower, block=64,
                                       device=CPU)
    for field in ("dense", "off_idx", "off_val", "rhs_order"):
        np.testing.assert_array_equal(np.asarray(getattr(tt, field)),
                                      np.asarray(getattr(jt, field)))
    b = np.random.default_rng(8).uniform(-1, 1, batch + (n,))
    assert_rel(tt.solve(torch.from_numpy(b)).numpy(),
               np.asarray(jt.solve(jnp.asarray(b))))


def test_sparse_lu_matches_jax():
    n = 300
    sp, _A = _dd_matrix(n, 0.02, seed=9)
    jlu = jm.sparse_lu(sp.indptr, sp.indices, sp.data, n, block=32)
    tlu = tm.sparse_lu(sp.indptr, sp.indices, sp.data, n, block=32,
                       device=CPU)
    assert tlu.nnz_factors == jlu.nnz_factors
    np.testing.assert_array_equal(tlu.perm, jlu.perm)
    for factor in ("L", "U"):
        for field in ("dense", "off_idx", "off_val"):
            np.testing.assert_array_equal(
                getattr(getattr(tlu, factor), field).numpy(),
                np.asarray(getattr(getattr(jlu, factor), field)))
    b = np.random.default_rng(2).uniform(-1, 1, (3, n))
    assert_rel(tlu.solve(torch.from_numpy(b)).numpy(),
               np.asarray(jlu.solve(jnp.asarray(b))))


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_stationary_matches_jax(method):
    Q = _birth_death(400, seed=1)
    want = np.asarray(jm.markov_stationary(jnp.asarray(Q), method=method))
    got = tm.markov_stationary(torch.from_numpy(Q), method=method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_stationary_csr_matches_jax():
    from scipy.sparse import csr_matrix
    sp = csr_matrix(_birth_death(400, seed=2))
    csr = (sp.indptr, sp.indices, sp.data)
    want = np.asarray(jm.markov_stationary(csr))
    got = tm.markov_stationary(csr, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_logic_errors_raise_in_both():
    from scipy.sparse import csr_matrix
    sp = csr_matrix(_birth_death(20))
    csr = (sp.indptr, sp.indices, sp.data)
    with pytest.raises(JaxLogicError):
        jm.markov_stationary(csr, method="dense")
    with pytest.raises(LogicError):
        tm.markov_stationary(csr, method="dense", device=CPU)
    singular = csr_matrix(np.array([[1.0, 2.0], [2.0, 4.0]]))
    with pytest.raises(JaxLogicError):
        jm.sparse_lu(singular.indptr, singular.indices, singular.data, 2)
    with pytest.raises(LogicError):
        tm.sparse_lu(singular.indptr, singular.indices, singular.data, 2,
                     device=CPU)
    lower = csr_matrix(np.tril(np.ones((4, 4)), k=-1))
    for compile_, error, extra in [
            (jm.compile_blocked_triangular, JaxLogicError, {}),
            (tm.compile_blocked_triangular, LogicError, {"device": CPU})]:
        with pytest.raises(error):
            compile_(lower.indptr, lower.indices, lower.data, np.ones(4),
                     lower=False, **extra)


def test_device_is_explicit():
    """numpy input needs ``device=``; a right-hand side on another device
    than the program's is refused, not moved."""
    from scipy.sparse import csr_matrix
    Q = _birth_death(20)
    with pytest.raises(LogicError):
        tm.markov_stationary(Q)
    with pytest.raises(LogicError):
        tm.markov_transient(Q, np.eye(20)[0], 1.0)
    sp = csr_matrix(np.tril(np.ones((4, 4)), k=-1))
    bt = tm.compile_blocked_triangular(sp.indptr, sp.indices, sp.data,
                                       np.ones(4), device="meta")
    with pytest.raises(LogicError):
        bt.solve(torch.ones(4))
