"""Packed Bernoulli states on the card: Philox4x32-10 against ``floor(p * 2^32)``.

Replaces ``canopy_tpu/ops/pallas_kernels.py:_packed_bernoulli_kernel``
(``packed_bernoulli``), which seeds the TPU core's own generator per grid
tile, draws 32 raw words per output word in VMEM, compares each against
the event's threshold and packs the 32 hits, so HBM sees only the packed
words.  The TPU's generator has no counterpart here, so the port keys a
counter-based generator instead: bit ``b`` of word ``w`` of event ``e`` is
set iff

    raw(seed, e, w, b) < thr[e]   (unsigned 32-bit compare)

where ``thr = min(floor(clip(p, 0, 1) * 2^32), 2^32 - 1)`` in float64 (the
reference's threshold) and ``raw`` is lane ``b % 4`` of Philox4x32-10 with
key ``(seed mod 2^32, e)`` and counter ``(w, b // 4, seed >> 32, 0)``.  The
word index ``w`` is global, so a run cut into word chunks draws the same
bits as one call.  As in the reference, ``p = 1`` misses only where
``raw == 2^32 - 1`` and ``p = 0`` never hits.

Trial ``t`` of event ``e`` is bit ``t % 32`` of word ``t // 32``
(``ops/bitpack.pack_states``'s layout).  Words are stored as ``torch.int32``
holding the 32-bit pattern: torch's ``uint32`` lacks most operations.

The kernel, ``csrc/bernoulli.cu``, runs one thread per (event, word), and
:func:`packed_bernoulli_plain` is its plain PyTorch version, bit for bit:
Philox in ``int64`` with every 32 x 32-bit product split into 16-bit
halves (a whole product overflows a signed 64-bit integer).
:func:`packed_bernoulli` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor, or raises; ``COUNTERS["launch.bernoulli"]``
counts its launches.
"""

from __future__ import annotations

import torch

from ..errors import LogicError
from ..utils.profiling import COUNTERS
from ._build import _raise_on, load_library

__all__ = ["PHILOX_M", "PHILOX_W", "bernoulli_thresholds", "philox4x32_10",
           "packed_bernoulli", "packed_bernoulli_plain"]

#: Philox4x32's round multipliers and Weyl key increments (Salmon et al.,
#: "Parallel random numbers: as easy as 1, 2, 3", SC 2011; Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
#: (event, word) pairs the plain version draws at once, eight Philox calls
#: each: small blocks stay in the CPU's caches; on the card they bound its
#: int64 temporaries to a few GB.
_PLAIN_BLOCK = {"cpu": 1 << 16, "cuda": 1 << 21}


def bernoulli_thresholds(basic_p: torch.Tensor) -> torch.Tensor:
    """``min(floor(clip(p, 0, 1) * 2^32), 2^32 - 1)`` in float64, as
    ``int64`` (the reference's thresholds, ``pallas_kernels.py:75-78``)."""
    p64 = torch.clamp(basic_p.to(torch.float64), 0.0, 1.0)
    return torch.clamp(torch.floor(p64 * 4294967296.0),
                       max=4294967295.0).to(torch.int64)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2^32)`` -> the same bits as ``int32``."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mulhilo(m: int, b: torch.Tensor):
    """High and low 32-bit halves of ``m * b`` for 32-bit ``m`` and ``b``
    (int64 tensors), through 16-bit halves of ``b`` so that no partial
    product reaches 2^63."""
    p_lo = m * (b & 0xFFFF)           # < 2^48
    p_hi = m * (b >> 16)              # < 2^48; the product is p_hi*2^16+p_lo
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (four 32-bit words) under ``key`` (two),
    each an ``int64`` tensor or a Python int, broadcast together; returns
    the four output words as ``int64`` tensors in ``[0, 2^32)``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check(seed: int, n_trials: int, word0: int) -> int:
    if seed < 0 or seed >= 1 << 64:
        raise LogicError(f"the Bernoulli seed must lie in [0, 2^64), got "
                         f"{seed}")
    if n_trials % 32:
        raise LogicError(f"n_trials must be a multiple of 32, got {n_trials}")
    n_words = n_trials // 32
    if word0 < 0 or word0 + n_words > 1 << 32:
        raise LogicError(f"words [{word0}, {word0 + n_words}) exceed the "
                         f"32-bit Philox counter")
    return n_words


def packed_bernoulli_plain(seed: int, basic_p: torch.Tensor, n_trials: int,
                           word0: int = 0) -> torch.Tensor:
    """The kernel's draw in plain torch (any device): ``(n_basic,
    n_trials // 32)`` ``int32`` words, the first being global word
    ``word0``."""
    n_words = _check(seed, n_trials, word0)
    device = basic_p.device
    thr = bernoulli_thresholds(basic_p)
    n_events = thr.shape[0]
    out = torch.empty((n_events, n_words), dtype=torch.int32, device=device)
    block = _PLAIN_BLOCK["cuda" if device.type == "cuda" else "cpu"]
    w_step = min(max(n_words, 1), block)
    e_step = max(1, block // w_step)
    key0, seed_hi = seed & _MASK32, seed >> 32
    # The word's eight Philox calls (counter word 1 = j) in one batch, so
    # each torch operation covers 8 x block elements.
    calls = torch.arange(8, dtype=torch.int64, device=device)[:, None, None]
    for e0 in range(0, n_events, e_step):
        e1 = min(e0 + e_step, n_events)
        events = torch.arange(e0, e1, dtype=torch.int64,
                              device=device)[None, :, None]
        t = thr[None, e0:e1, None]
        for w0 in range(0, n_words, w_step):
            w1 = min(w0 + w_step, n_words)
            words = torch.arange(word0 + w0, word0 + w1, dtype=torch.int64,
                                 device=device)[None, None, :]
            lanes = philox4x32_10((words, calls, seed_hi, 0), (key0, events))
            # Bit 4 j + i of the word is lane i of call j: distinct bits,
            # so their sum is their union.
            acc = sum(((raw < t).to(torch.int64) << (4 * calls + i))
                      for i, raw in enumerate(lanes)).sum(0)
            out[e0:e1, w0:w1] = _to_int32(acc)
    return out


def packed_bernoulli(seed: int, basic_p: torch.Tensor, n_trials: int,
                     word0: int = 0) -> torch.Tensor:
    """``(n_basic, n_trials // 32)`` packed Bernoulli states of
    ``basic_p`` (``(n_basic,)`` probabilities), as ``int32`` words.

    ``word0`` is the global index of the first word: the draws of words
    ``[word0, word0 + n_trials // 32)`` are those of one call over all of
    them.  A CPU tensor runs :func:`packed_bernoulli_plain`; a CUDA tensor
    launches ``csrc/bernoulli.cu`` or raises.
    """
    if basic_p.ndim != 1:
        raise LogicError(f"basic_p must be (n_basic,), got "
                         f"{tuple(basic_p.shape)}")
    if basic_p.device.type != "cuda":
        return packed_bernoulli_plain(seed, basic_p, n_trials, word0)
    n_words = _check(seed, n_trials, word0)
    lib = load_library()
    device = basic_p.device
    thr = _to_int32(bernoulli_thresholds(basic_p)).contiguous()
    out = torch.empty((thr.shape[0], n_words), dtype=torch.int32,
                      device=device)
    if out.numel() == 0:
        return out
    COUNTERS["launch.bernoulli"] += 1
    code = lib.canopy_packed_bernoulli(
        thr.data_ptr(), thr.shape[0], n_words, word0, seed & _MASK32,
        seed >> 32, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "packed Bernoulli")
    return out
