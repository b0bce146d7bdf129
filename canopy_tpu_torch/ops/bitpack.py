"""Bit-packed Monte Carlo state evaluation on torch: 32 trials per word.

``canopy_tpu/ops/bitpack.py`` on torch.  Bernoulli basic-event states are
packed 32 to a word (trial ``t`` in word ``t // 32``, bit ``t % 32``) and
every gate evaluates with bitwise operations:

* ``prod`` — ``out = inv_out ^ AND_f (flip ^ arg)`` with all-ones padding;
* ``pair`` — bitwise xor / xnor;
* ``count`` (atleast/cardinality) — a bit-sliced ripple-carry counter
  (``B = ceil(log2(F + 1))`` planes accumulate the per-trial argument
  count with and/xor), then a bitwise magnitude comparator for
  ``min <= count <= max``.  No unpacking anywhere.

The JAX package leaves these to XLA, and so does the port to torch's
bitwise operations; the one kernel of the path is the sampler,
``ops/bernoulli_kernel.packed_bernoulli`` (``csrc/bernoulli.cu``), which
:func:`packed_top_probability` calls.  Words are ``torch.int32`` holding
the 32-bit pattern (torch's ``uint32`` lacks most operations).  Product
and count gates read one fan-in column at a time, so no ``(G, F, W)``
gather is ever materialised; the results are the reference's bit for bit
(and/or/xor are exact).
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree, CountBlock, PairBlock, ProdBlock
from ..errors import LogicError
from .prng import uniform

__all__ = ["pack_states", "sample_states_packed", "propagate_packed",
           "packed_top_probability", "popcount_mean", "popcount"]

_FULL = -1   # all 32 bits set, as int32
#: Word-chunk budget of :func:`packed_top_probability` on the CPU (bytes).
_CPU_CHUNK_BYTES = 1 << 28
#: Share of the card's free memory one word chunk may take.
_CUDA_CHUNK_SHARE = 0.5


def _t(array, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def pack_states(states: torch.Tensor) -> torch.Tensor:
    """``(n_trials, n_nodes)`` {0, 1} -> ``(n_nodes, n_trials // 32)``
    ``int32`` words.  ``n_trials`` must be a multiple of 32."""
    n_trials, n_nodes = states.shape
    if n_trials % 32:
        raise LogicError(f"n_trials must be a multiple of 32, got {n_trials}")
    bits = (states != 0).to(torch.int64).T.reshape(n_nodes, n_trials // 32,
                                                    32)
    weights = torch.ones(32, dtype=torch.int64, device=states.device) \
        << torch.arange(32, device=states.device)
    words = (bits * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def sample_states_packed(key, basic_p: torch.Tensor,
                         n_trials: int) -> torch.Tensor:
    """Packed Bernoulli states ``(n_basic, n_trials // 32)`` drawn as
    float32 uniforms below ``p`` (the reference's XLA formulation, under
    the threefry key ``key``: the JAX package's states)."""
    if n_trials % 32:
        raise LogicError(f"n_trials must be a multiple of 32, got {n_trials}")
    u = uniform(key, (n_trials, basic_p.shape[-1]), torch.float32,
                device=basic_p.device)
    return pack_states(u < basic_p.to(torch.float32)[None, :])


def _prod_packed(vals: torch.Tensor, block: ProdBlock) -> torch.Tensor:
    dev = vals.device
    acc = None
    for f in range(block.arg_idx.shape[1]):
        v = vals[_t(block.arg_idx[:, f].astype(np.int64), dev)]
        x = torch.where(_t(block.arg_flip[:, f], dev)[:, None], ~v, v)
        if not block.arg_mask[:, f].all():
            x = torch.where(_t(block.arg_mask[:, f], dev)[:, None], x,
                            _FULL)                       # AND identity.
        acc = x if acc is None else acc & x
    return torch.where(_t(block.inv_out, dev)[:, None], ~acc, acc)


def _pair_packed(vals: torch.Tensor, block: PairBlock) -> torch.Tensor:
    dev = vals.device
    v = vals[_t(block.arg_idx.astype(np.int64), dev)]    # (G, 2, W)
    v = torch.where(_t(block.arg_neg, dev)[..., None], ~v, v)
    x = v[:, 0, :] ^ v[:, 1, :]
    return torch.where(_t(block.is_iff, dev)[:, None], ~x, x)


def _count_packed(vals: torch.Tensor, block: CountBlock) -> torch.Tensor:
    """Bit-sliced counting + lane-parallel magnitude comparison."""
    dev = vals.device
    G, F = block.arg_idx.shape
    W = vals.shape[1]
    n_planes = max(int(np.ceil(np.log2(F + 1))), 1)
    planes = [vals.new_zeros((G, W)) for _ in range(n_planes)]
    for f in range(F):
        v = vals[_t(block.arg_idx[:, f].astype(np.int64), dev)]
        carry = torch.where(_t(block.arg_neg[:, f], dev)[:, None], ~v, v)
        if not block.arg_mask[:, f].all():
            carry = torch.where(_t(block.arg_mask[:, f], dev)[:, None],
                                carry, 0)                # Padding never counts.
        for b in range(n_planes):
            planes[b], carry = planes[b] ^ carry, planes[b] & carry
        # carry out of the top plane cannot happen: F < 2^n_planes.

    def count_geq(k: np.ndarray) -> torch.Tensor:
        """Bitwise comparator: lanes where count >= k (per-gate k).

        Thresholds beyond the counter's range (k >= 2^n_planes) are
        unreachable: the comparator would otherwise wrap k modulo the
        plane count and compare against k's low bits only.
        """
        ge = vals.new_zeros((G, W))
        eq = vals.new_full((G, W), _FULL)
        for b in range(n_planes - 1, -1, -1):
            kb_mask = _t(np.where((k >> b) & 1, _FULL, 0).astype(np.int32),
                         dev)[:, None]
            ge = ge | (eq & planes[b] & ~kb_mask)
            eq = eq & ~(planes[b] ^ kb_mask)
        reachable = _t(k < (1 << n_planes), dev)[:, None]
        return torch.where(reachable, ge | eq, 0)

    min_num = np.asarray(block.min_num)
    max_num = np.asarray(block.max_num)
    geq_min = count_geq(min_num) if min_num.max() > 0 else \
        vals.new_full((G, W), _FULL)
    gt_max = count_geq(max_num + 1)
    return geq_min & ~gt_max


_EVALUATORS = {"prod": _prod_packed, "pair": _pair_packed,
               "count": _count_packed}


def propagate_packed(tree: CompiledTree, packed_basic: torch.Tensor,
                     house_states) -> torch.Tensor:
    """Bitwise bottom-up evaluation; returns ``(n_nodes, n_words)`` words.

    ``packed_basic``: ``(n_basic, W)`` ``int32`` words; ``house_states``:
    ``(n_house,)`` states broadcast to all-zero/all-one words.  Gate rows
    are written in place into one value matrix.
    """
    n_b, n_h = tree.n_basic, tree.n_house
    W = packed_basic.shape[-1]
    vals = packed_basic.new_zeros((tree.n_nodes, W))
    vals[:n_b] = packed_basic
    if n_h:
        house = house_states if torch.is_tensor(house_states) else \
            torch.from_numpy(np.asarray(house_states, dtype=np.float64))
        house = house.to(device=vals.device, dtype=torch.float64)
        vals[n_b:n_b + n_h] = torch.where(house > 0.5, _FULL, 0).to(
            torch.int32)[:, None]
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            if block.n_gates:
                out = _EVALUATORS[kind](vals, block)
                vals.index_copy_(0, _t(block.out_idx.astype(np.int64),
                                       vals.device), out)
    return vals


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR in ``int64``)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount_mean(words: torch.Tensor, n_trials: int) -> torch.Tensor:
    """Fraction of set bits across the word axis (Bernoulli estimate)."""
    return popcount(words).sum(-1).to(torch.float64) / n_trials


def _bytes_per_word(tree: CompiledTree) -> int:
    """Device bytes one word of trials takes in a chunk: the sampled basic
    words, the value matrix, and the widest block's temporaries (a
    product's column, flipped column and accumulator; a count's planes,
    carry and comparator)."""
    temp = 0
    for level in tree.levels:
        for kind, block in level.iter_blocks():
            G, F = block.arg_idx.shape[0], block.arg_idx.shape[-1]
            if kind == "prod":
                rows = 4 * G
            elif kind == "pair":
                rows = 6 * G
            else:
                rows = (max(int(np.ceil(np.log2(F + 1))), 1) + 6) * G
            temp = max(temp, rows)
    return 4 * (2 * tree.n_basic + tree.n_nodes + temp)


def _chunk_words(tree: CompiledTree, n_words: int,
                 device: torch.device) -> int:
    """Words of trials per chunk of :func:`packed_top_probability`: what
    half the card's free memory holds (a fixed 256 MiB on the CPU)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        free += torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        budget = int(free * _CUDA_CHUNK_SHARE)
    else:
        budget = _CPU_CHUNK_BYTES
    return max(1, min(n_words, budget // _bytes_per_word(tree)))


def packed_top_probability(tree: CompiledTree, seed: int,
                           basic_p: torch.Tensor, n_trials: int,
                           house_states, device,
                           stats: dict | None = None) -> float:
    """Monte Carlo top-event estimate through the bit-packed engine.

    Draws ``n_trials`` (a multiple of 32) Bernoulli states of every basic
    event with ``ops/bernoulli_kernel.packed_bernoulli`` (the kernel on
    CUDA, which raises rather than fall back), propagates them bitwise and
    counts the top's set bits.  Trials run in word chunks sized to the
    device's free memory; the draws are keyed on the global word index,
    so chunking changes no bit.
    ``house_states`` defaults to the tree's.  ``stats``, if given,
    receives the chunk plan.
    """
    from .bernoulli_kernel import packed_bernoulli
    if tree.top_index is None:
        raise LogicError("Monte Carlo needs an anchored top event")
    if n_trials % 32 or n_trials <= 0:
        raise LogicError(f"n_trials must be a positive multiple of 32, got "
                         f"{n_trials}")
    device = torch.device(device)
    if house_states is None:
        house_states = tree.house_state_vector()
    p = torch.as_tensor(basic_p, dtype=torch.float64).to(device)
    n_words = n_trials // 32
    chunk = _chunk_words(tree, n_words, device)
    hits = 0
    for w0 in range(0, n_words, chunk):
        n = min(chunk, n_words - w0)
        packed = packed_bernoulli(seed, p, 32 * n, word0=w0)
        vals = propagate_packed(tree, packed, house_states)
        del packed
        hits += int(popcount(vals[tree.top_index]).sum())
        del vals
    if stats is not None:
        stats.update(chunk_words=chunk, chunks=-(-n_words // chunk),
                     n_words=n_words, bytes_per_word=_bytes_per_word(tree))
    return hits / n_trials
