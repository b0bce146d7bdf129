"""Importance analysis via automatic differentiation.

The importance surface of the reference Settings
(``settings.h:262-278``): because the propagated top-event probability is
*multilinear* in each basic-event probability, the Birnbaum marginal
importance factor

    MIF_i = dP(top)/dp_i = P(top | x_i=1) - P(top | x_i=0)

is exact, and one reverse-mode pass (torch autograd; on CUDA through the
adjoint kernel, over the exact BDD's stream program or, without one, the
tree's: :func:`make_stream_importance_fn`) yields every event's MIF at
once. All other measures derive algebraically from (P, p, MIF):

    P(top | x_i=1) = P + (1 - p_i) * MIF_i
    P(top | x_i=0) = P - p_i * MIF_i
    CIF_i = p_i * MIF_i / P            (criticality)
    DIF_i = p_i * P(top|x_i=1) / P     (diagnosis / Fussell-Vesely-style)
    RAW_i = P(top|x_i=1) / P           (risk achievement worth)
    RRW_i = P / P(top|x_i=0)           (risk reduction worth)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from .propagate import top_event_probability

__all__ = ["ImportanceResult", "importance_measures",
           "make_stream_importance_fn", "occurrence_counts"]


@dataclasses.dataclass
class ImportanceResult:
    """Per-basic-event importance measures (arrays indexed by basic slot)."""

    top_probability: float
    mif: np.ndarray
    cif: np.ndarray
    dif: np.ndarray
    raw: np.ndarray
    rrw: np.ndarray
    occurrences: np.ndarray | None = None

    def as_table(self, tree: CompiledTree) -> list[dict]:
        rows = []
        for event_id, slot in tree.basic_index.items():
            row = {"event": event_id,
                   "MIF": float(self.mif[slot]),
                   "CIF": float(self.cif[slot]),
                   "DIF": float(self.dif[slot]),
                   "RAW": float(self.raw[slot]),
                   "RRW": float(self.rrw[slot])}
            if self.occurrences is not None:
                row["occurrence"] = int(self.occurrences[slot])
            rows.append(row)
        return rows


def importance_measures(tree: CompiledTree, basic_p: torch.Tensor,
                        house_states: torch.Tensor | None = None,
                        top_fn=None) -> ImportanceResult:
    """All importance measures from one forward + one backward pass.

    ``top_fn(p) -> P(top)`` overrides the evaluator (e.g. the exact BDD
    evaluator); default is direct propagation.
    """
    p = basic_p.detach().clone().requires_grad_(True)
    if top_fn is not None:
        top = top_fn(p)
    else:
        if house_states is None:
            house_states = torch.as_tensor(tree.house_state_vector(),
                                           device=p.device)
        top = top_event_probability(tree, p, house_states)
    mif = None
    if top.requires_grad:  # A constant top carries no graph.
        (mif,) = torch.autograd.grad(top, p, allow_unused=True)
    p = p.detach()
    p_top = top.detach().to(p.dtype)
    mif = torch.zeros_like(p) if mif is None else mif.to(p.dtype)
    p_one = p_top + (1.0 - p) * mif
    p_zero = p_top - p * mif
    safe_top = torch.where(p_top > 0, p_top, 1.0)
    cif = torch.where(p_top > 0, p * mif / safe_top, 0.0)
    dif = torch.where(p_top > 0, p * p_one / safe_top, 0.0)
    raw = torch.where(p_top > 0, p_one / safe_top, 0.0)
    safe_zero = torch.where(p_zero > 0, p_zero, 1.0)
    rrw = torch.where(p_zero > 0, p_top / safe_zero, torch.inf)
    return ImportanceResult(
        top_probability=float(p_top),
        mif=mif.cpu().numpy(), cif=cif.cpu().numpy(),
        dif=dif.cpu().numpy(), raw=raw.cpu().numpy(),
        rrw=rrw.cpu().numpy())


def make_stream_importance_fn(tree: CompiledTree, house_states, device):
    """A differentiable ``top_fn(p)`` over the tree's uncapped stream
    program (``ops/stream_kernel.compile_tree_stream``), whose backward
    runs the adjoint kernel: direct-propagation semantics, the same math
    as the gather engine.

    The JAX package broadcasts ``p`` onto 1,024 float32 lanes and means
    them; here the kernels run one trial in float64, as importance over a
    BDD does (float32 partials cancel; ROADMAP.md Queue 3).  The program
    exists for every tree with an anchored top, so on CUDA this never
    returns ``None``; on the CPU it runs the kernels' plain versions.
    ``p`` must lie on ``device``: nothing is moved between devices.
    """
    from ..errors import LogicError
    from ..ops.adjoint_kernel import make_differentiable_stream
    from ..ops.stream_kernel import stage_basic, tree_stream_encoding
    device = torch.device(device)
    enc = tree_stream_encoding(tree)
    house = tree.house_state_vector() if house_states is None \
        else np.asarray(house_states)
    f = make_differentiable_stream(enc, house)

    def top_fn(p):
        if p.device.type != device.type:
            raise LogicError(f"importance runs on {device}, got p on "
                             f"{p.device}")
        return f(stage_basic(enc, p[None, :], torch.float64))[0]
    return top_fn


def _make_replay_importance_fn(tree: CompiledTree, house_states, device):
    """A differentiable ``top_fn(p)`` over the tree's replay program,
    whose backward runs the replay backward kernel
    (``ops/replay_adjoint_kernel.py``): the JAX package's importance path
    for trees its stream pool rejects.

    On CUDA the tree's uncapped stream serves every anchored tree, so
    :func:`make_stream_importance_fn` keeps the stream adjoint and this
    helper is reached explicitly (``importance_measures(...,
    top_fn=...)``).  Forward segments are capped at 2,048 ops as in the
    JAX package; one float64 trial, as the stream path runs.  A tree the
    builder cannot schedule raises ``LogicError``: there is no fallback.
    """
    from ..errors import LogicError
    from ..ops.replay_adjoint_kernel import (compile_replay_adjoint,
                                             make_differentiable_replay)
    from ..ops.stream_kernel import encode_replay, stage_replay
    device = torch.device(device)
    aprog = compile_replay_adjoint(tree, max_ops_per_segment=2048)
    enc = encode_replay(aprog.base)
    house = tree.house_state_vector() if house_states is None \
        else np.asarray(house_states)
    f = make_differentiable_replay(aprog, house)

    def top_fn(p):
        if p.device.type != device.type:
            raise LogicError(f"importance runs on {device}, got p on "
                             f"{p.device}")
        return f(stage_replay(enc, p[None, :], torch.float64))[0]
    return top_fn


def occurrence_counts(products, n_basic: int) -> np.ndarray:
    """How many minimal products each basic event appears in."""
    counts = np.zeros(n_basic, dtype=np.int64)
    for product in products:
        for slot, _neg in product:
            counts[slot] += 1
    return counts
