"""Markov-chain inputs of realistic size for ``ops/markov.py``.

* :func:`birth_death_csr` — the 10,000-state birth-death chain with
  random long-range jumps of ``tests/test_markov.py``'s
  ``test_csr_input_10k_states`` (a CSR generator, built with scipy);
* :func:`random_lower_csr` — ``tests/test_markov.py``'s ``_random_lower``
  (a strictly lower-triangular CSR and a diagonal) from the same draws,
  generated in row chunks so no dense (n, n) matrix is built;
* :func:`repairable_components` — the generator of ``k`` independent
  two-state repairable components (up -> down at ``lam``, down -> up at
  ``mu``): the Kronecker sum of their 2 x 2 generators, ``2^k`` states.
"""

from __future__ import annotations

import numpy as np

__all__ = ["birth_death_csr", "random_lower_csr", "repairable_components"]


def birth_death_csr(n: int = 10_000, seed: int = 3):
    """A birth-death CTMC generator with ``n // 50`` random jumps, as a
    ``scipy.sparse`` CSR matrix (rows sum to 0)."""
    from scipy.sparse import coo_matrix
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(1, n), np.arange(n - 1)])
    vals = rng.uniform(0.5, 1.5, 2 * (n - 1))
    ji = rng.integers(0, n, (n // 50, 2))
    ji = ji[ji[:, 0] != ji[:, 1]]
    rows = np.concatenate([rows, ji[:, 0]])
    cols = np.concatenate([cols, ji[:, 1]])
    vals = np.concatenate([vals, rng.uniform(0.1, 0.5, len(ji))])
    off = coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    diag = -np.asarray(off.sum(axis=1)).ravel()
    return (off + coo_matrix((diag, (np.arange(n), np.arange(n))),
                             shape=(n, n))).tocsr()


def random_lower_csr(n: int, density: float, seed: int,
                     chain: bool = False, rows_per_chunk: int = 512):
    """``(indptr, indices, data, diag)``: the strictly lower part of
    ``_random_lower(n, density, seed, chain)`` in CSR and its diagonal.

    The draws are the dense generator's (``random((n, n))``, then
    ``uniform(0.1, 1.0, (n, n))``, the chain's sub-diagonal, the
    diagonal), taken ``rows_per_chunk`` rows at a time.
    """
    rng = np.random.default_rng(seed)
    picked = []
    for r0 in range(0, n, rows_per_chunk):
        block = rng.random((min(rows_per_chunk, n - r0), n)) < density
        i, j = np.nonzero(block)
        keep = j < i + r0
        picked.append((i[keep] + r0, j[keep]))
    rows = np.concatenate([i for i, _ in picked])
    cols = np.concatenate([j for _, j in picked])
    flat = rows * n + cols
    vals = np.empty(len(flat))
    at = 0
    for r0 in range(0, n, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, n)
        block = rng.uniform(0.1, 1.0, (r1 - r0, n)).ravel()
        end = np.searchsorted(flat, r1 * n)
        vals[at:end] = block[flat[at:end] - r0 * n]
        at = end
    entries = dict(zip(flat.tolist(), vals.tolist()))
    if chain:
        sub = rng.uniform(0.5, 1.0, n - 1)
        entries.update(zip((np.arange(1, n) * n + np.arange(n - 1)).tolist(),
                           sub.tolist()))
    diag = rng.uniform(0.5, 2.0, n)
    keys = np.array(sorted(entries), dtype=np.int64)
    data = np.array([entries[k] for k in keys.tolist()])
    indptr = np.searchsorted(keys, np.arange(n + 1) * n).astype(np.int64)
    return indptr, keys % n, data, diag


def repairable_components(k: int, seed: int, lam=(1e-3, 1e-2),
                          mu=(0.05, 0.5)) -> np.ndarray:
    """The dense ``(2^k, 2^k)`` generator of ``k`` independent repairable
    components, rates drawn uniformly from the ``lam`` and ``mu`` ranges
    (per hour).  State bit ``i`` set: component ``i`` is down."""
    rng = np.random.default_rng(seed)
    q = np.zeros((1, 1))
    for _ in range(k):
        a, b = rng.uniform(*lam), rng.uniform(*mu)
        g = np.array([[-a, a], [b, -b]])
        q = np.kron(np.eye(2), q) + np.kron(g, np.eye(len(q)))
    return q
