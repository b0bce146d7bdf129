"""Quantification over minimal cut sets: the sparse-matrix compute path.

The cut-set matrix C (rows = products, cols = signed basic-event slots) is
the CSR operand named in the north star (BASELINE.json): per-product
probabilities are a row-wise product-reduce — an SpMV in the (x, *)
semiring, evaluated here in log space as a true CSR SpMV (sum of gathered
log-probabilities per row) — and batching probability vectors over a trials
axis turns it into the SpMM used by uncertainty propagation.

Two layouts are built at compile time:

* **padded** (ELL): (n_products, max_order) gather indices + sign + mask;
  the gather layout for the bounded orders produced by ``limit_order``
  (<= 20).
* **CSR**: indptr/indices/signs for a segment-reduce path.

Approximations (reference ``settings.h:19-22`` semantics):

* ``rare_event``: P ~= sum_k Q_k (upper bound, first Sylwester term);
* ``mcub``: P ~= 1 - prod_k (1 - Q_k) (min-cut-set upper bound);
* exact probability over products by inclusion-exclusion is exponential
  and intentionally not provided here — the direct-propagation and
  Monte-Carlo engines cover the exact/simulation paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.cutsets import Product

__all__ = ["CutSetMatrix", "build_cutset_matrix", "product_probabilities",
           "rare_event", "mcub"]


@dataclasses.dataclass
class CutSetMatrix:
    """Cut sets in both padded (ELL) and CSR layouts."""

    n_products: int
    n_basic: int
    max_order: int
    # Padded layout.
    idx: np.ndarray     # (n_products, max_order) int32 basic slots (pad 0)
    neg: np.ndarray     # (n_products, max_order) bool
    mask: np.ndarray    # (n_products, max_order) bool
    # CSR layout.
    indptr: np.ndarray   # (n_products + 1,) int32
    indices: np.ndarray  # (nnz,) int32
    signs: np.ndarray    # (nnz,) int8: +1 positive literal, -1 complement
    orders: np.ndarray   # (n_products,) int32 product order

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def build_cutset_matrix(products: list[Product],
                        n_basic: int) -> CutSetMatrix:
    n = len(products)
    orders = np.array([len(p) for p in products], dtype=np.int32)
    max_order = int(orders.max()) if n else 1
    max_order = max(max_order, 1)
    idx = np.zeros((n, max_order), dtype=np.int32)
    neg = np.zeros((n, max_order), dtype=bool)
    mask = np.zeros((n, max_order), dtype=bool)
    indptr = np.zeros(n + 1, dtype=np.int32)
    indices_list: list[int] = []
    signs_list: list[int] = []
    for i, product in enumerate(products):
        literals = sorted(product)
        for j, (slot, is_neg) in enumerate(literals):
            idx[i, j] = slot
            neg[i, j] = is_neg
            mask[i, j] = True
            indices_list.append(slot)
            signs_list.append(-1 if is_neg else 1)
        indptr[i + 1] = indptr[i] + len(literals)
    return CutSetMatrix(
        n_products=n, n_basic=n_basic, max_order=max_order, idx=idx, neg=neg,
        mask=mask, indptr=indptr,
        indices=np.array(indices_list, dtype=np.int32),
        signs=np.array(signs_list, dtype=np.int8), orders=orders)


def product_probabilities(matrix: CutSetMatrix,
                          basic_p: torch.Tensor) -> torch.Tensor:
    """Per-product probabilities Q_k; batched over leading axes of basic_p.

    Padded-gather layout: one gather + masked product-reduce per row (the
    ELL SpMV). ``basic_p``: (..., n_basic).
    """
    if matrix.n_products == 0:
        return basic_p.new_zeros(basic_p.shape[:-1] + (0,))
    dev = basic_p.device
    v = basic_p[..., torch.from_numpy(matrix.idx.astype(np.int64)).to(dev)]
    v = torch.where(torch.from_numpy(matrix.neg).to(dev), 1.0 - v, v)
    v = torch.where(torch.from_numpy(matrix.mask).to(dev), v, 1.0)
    return torch.prod(v, dim=-1)


def rare_event(q: torch.Tensor) -> torch.Tensor:
    """Rare-event approximation: sum of product probabilities, capped at 1."""
    return torch.clamp(torch.sum(q, dim=-1), max=1.0)


def mcub(q: torch.Tensor) -> torch.Tensor:
    """Min-cut-set upper bound: 1 - prod(1 - Q_k)."""
    return -torch.expm1(torch.sum(torch.log1p(
        -torch.clamp(q, max=1.0 - 1e-18)), dim=-1))
