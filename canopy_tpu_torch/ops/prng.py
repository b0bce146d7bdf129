"""Counter-based draws keyed as ``jax.random`` keys them: threefry2x32.

The JAX package samples through ``jax.random`` under its defaults
(``threefry2x32``, ``jax_threefry_partitionable=True``, float64).  This
module is the port's counterpart of the functions it calls, written out
from their definitions in JAX's ``_src/prng.py`` and ``_src/random.py``
and named after them, so that the same seed gives the same draws:

* **Keys** are two 32-bit words, held here as a tuple of Python ints:
  :func:`prng_key` (``threefry_seed``: the seed's high and low words),
  :func:`fold_in` (``threefry_fold_in``: the hash of the counter ``(0,
  data)``) and :func:`split` (``_threefry_split_foldlike``: key ``i`` is
  the hash of the counter ``(0, i)``).
* **Bits** (:func:`random_bits`, ``_threefry_random_bits_partitionable``):
  element ``f`` of a draw (its row-major flat index) hashes the counter
  ``(f >> 32, f mod 2^32)`` to two words ``(b1, b2)``; a 32-bit draw is
  ``b1 ^ b2``, a 64-bit one ``b1 << 32 | b2``.
* **Transforms**: :func:`uniform` (``_uniform``'s mantissa trick),
  :func:`normal` (``_normal_real``: a uniform on ``[nextafter(-1, 0),
  1)`` through ``sqrt(2) * erf_inv``, with :func:`erf_inv` the float64
  polynomial XLA compiles ``lax.erf_inv`` to, constants as its HLO prints
  them), :func:`gamma` and :func:`loggamma` (``_gamma_impl``: element
  ``i`` draws under ``split(key, size)[i]`` by ``_gamma_one``'s
  Marsaglia-Tsang loop with its key splits, the ``alpha < 1`` boost and
  ``log_space``), :func:`beta` (``_beta``), :func:`gumbel` (``_gumbel``,
  mode "low") and :func:`categorical` (the Gumbel-max pick).

Integers and uniforms equal JAX's bit for bit; the transcendental
transforms (``log1p``, ``log``, ``exp``) round as the device's math
library rounds, within a few units in the last place of XLA's.  One
departs from XLA's operation: ``_gamma_one``'s boost ``pow(1 - u, 1 /
alpha)`` is ``exp(log(1 - u) / alpha)`` here and in the kernel, because
the math library's ``pow``, compiled into a kernel built with
``--fmad=false``, rounds otherwise than torch's on the card (for
exponents above about 100); the two differ from XLA's ``pow`` by at most
``|log(result)|`` ulps, 1e-13 relative for results above 1e-300.

Two kernels in ``csrc/prng.cu`` draw on the card, and beside each is its
plain PyTorch version (32-bit words in ``int64`` tensors, masked after
every addition), which a CPU tensor takes:

* :func:`draw_standard` fills an ``(n_trials, n_cols)`` float64 block
  from a table of rows, one launch for all of them.  A row is a key, a
  kind (uniform, float32 uniform, normal or Gumbel), a transform (none,
  ``p0 + p1 * x`` or ``exp(p0 + p1 * x)``), a counter stride and offset
  (trial ``t`` draws element ``t * stride + offset``) and the column it
  writes.
* :func:`draw_gamma` draws ``_gamma_one`` per element, one thread each.

On a CUDA device they launch their kernel or raise; ``COUNTERS["launch.prng"]``
counts the launches.  The public samplers route through them, so a CUDA
draw of any kind is a kernel's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..errors import LogicError
from ..utils.profiling import COUNTERS, to_device
from ._build import _raise_on, load_library

__all__ = ["prng_key", "fold_in", "fold_in_many", "split", "threefry_2x32",
           "random_bits", "erf_inv", "uniform", "normal", "gamma", "loggamma", "beta",
           "gumbel", "categorical", "StandardTable", "draw_standard",
           "draw_standard_plain", "draw_gamma", "draw_gamma_plain",
           "UNIFORM", "UNIFORM32", "NORMAL", "GUMBEL", "NONE", "AFFINE",
           "EXP_AFFINE", "beta_from_logs"]

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_F64 = torch.float64
_I64 = torch.int64
#: threefry2x32's rotations (two alternating groups of four rounds) and
#: key-schedule parity constant (Salmon et al., SC 2011; JAX's
#: ``_threefry2x32_lowering``).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: Row kinds and transforms of :func:`draw_standard` (``csrc/prng.cu``).
UNIFORM, UNIFORM32, NORMAL, GUMBEL = 0, 1, 2, 3
NONE, AFFINE, EXP_AFFINE = 0, 1, 2

#: ``np.nextafter(-1.0, 0.0)``: ``_normal_real``'s lower bound.
_NORMAL_LO = -0.9999999999999999
#: ``np.sqrt(2)`` in float64.
_SQRT2 = 1.4142135623730951
#: float64's smallest normal number, ``_gumbel``'s lower bound.
_TINY = 2.2250738585072014e-308

#: XLA's float64 ``erf_inv`` (Giles' approximation): ``w = -log1p(-x^2)``;
#: below 6.25 a degree-22 polynomial in ``w - 3.125``, below 16 a
#: degree-18 one in ``sqrt(w) - 3.25``, else a degree-16 one in ``sqrt(w)
#: - 5``, each by Horner from its first coefficient, times ``x``.  The
#: constants as the compiled HLO of ``jax.lax.erf_inv`` on float64 prints
#: them.
_ERFINV_A = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
    6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
    1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027)
_ERFINV_B = (
    2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
    0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
    -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
    3.0838856104922208)
_ERFINV_C = (
    -2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
    7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.8499064014085844)

#: Elements the plain versions compute at once.  On the card this bounds
#: their int64 temporaries (a few hundred MB); on the CPU it keeps every
#: torch operation below torch's parallel grain (32,768 elements), so the
#: many small operations of a draw run on one thread each and stay in
#: cache, however many processes share the cores.
_PLAIN_BLOCK = {"cpu": 1 << 15, "cuda": 1 << 23}


def _block(device: torch.device) -> int:
    return _PLAIN_BLOCK["cuda" if device.type == "cuda" else "cpu"]


# ---------------------------------------------------------------------------
# Keys and bits.
# ---------------------------------------------------------------------------

def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry_2x32(key, x0, x1):
    """threefry2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``; words are Python ints or ``int64`` tensors in ``[0, 2^32)``,
    broadcast together.  Returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def _as_key(key) -> tuple[int, int]:
    """Two 32-bit words from a tuple, list, array or tensor of two."""
    k0, k1 = (int(k) for k in key)
    return k0 & _MASK32, k1 & _MASK32


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed as a signed 64-bit integer,
    its high word then its low word."""
    seed = int(seed)
    if not -(1 << 63) <= seed < 1 << 63:
        raise LogicError(f"a PRNG seed must fit in int64, got {seed}")
    seed &= _MASK64
    return seed >> 32, seed & _MASK32


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` (``data`` taken mod 2^32)."""
    return threefry_2x32(_as_key(key), 0, int(data) & _MASK32)


def fold_in_many(key, data) -> list[tuple[int, int]]:
    """``[fold_in(key, d) for d in data]`` in one vectorised hash."""
    d = torch.tensor(list(data), dtype=_I64) & _MASK32
    y0, y1 = threefry_2x32(_as_key(key), torch.zeros_like(d), d)
    return list(zip(y0.tolist(), y1.tolist()))


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as a list of keys."""
    key = _as_key(key)
    return [threefry_2x32(key, 0, i) for i in range(num)]


def _counter(flat: torch.Tensor):
    return flat >> 32, flat & _MASK32


def random_bits(key, bit_width: int, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint{bit_width})`` for 32 or 64 bits,
    as ``int64`` (a 64-bit draw holds the unsigned pattern)."""
    shape = tuple(shape)
    flat = torch.arange(math.prod(shape), dtype=_I64,
                        device=torch.device(device))
    b1, b2 = threefry_2x32(_as_key(key), *_counter(flat))
    if bit_width == 32:
        out = b1 ^ b2
    elif bit_width == 64:
        out = (b1 << 32) | b2
    else:
        raise LogicError(f"random_bits takes 32 or 64 bits, not {bit_width}")
    return out.reshape(shape)


def _f64_from_words(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``_uniform``'s float64 in [0, 1): the top 52 bits of ``b1 << 32 |
    b2`` as the mantissa of a number in [1, 2), less 1."""
    mant = (b1 << 20) | (b2 >> 12)
    return (mant | 0x3FF0000000000000).view(_F64) - 1.0


def _f32_from_words(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``_uniform``'s float32 in [0, 1) from the 32-bit draw ``b1 ^ b2``,
    widened to float64 (exactly)."""
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).to(_F64)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``, operation for operation (the compiled
    HLO's select-per-coefficient Horner form)."""
    w = -torch.log1p(x * -x)
    lt625 = w < 6.25
    lt16 = w < 16.0

    def pick(cond, a, b):
        # torch.where of two Python floats would give float32.
        return torch.where(cond, torch.tensor(a, dtype=_F64, device=x.device),
                           torch.tensor(b, dtype=_F64, device=x.device))

    wt = torch.where(lt625, w - 3.125, torch.sqrt(w) - pick(lt16, 3.25, 5.0))

    def coef(i):
        return torch.where(lt625, _ERFINV_A[i],
                           pick(lt16, _ERFINV_B[i], _ERFINV_C[i]))

    p = coef(0)
    for i in range(1, len(_ERFINV_C)):
        p = coef(i) + p * wt
    for i in range(len(_ERFINV_C), len(_ERFINV_B)):
        p = torch.where(lt16, pick(lt625, _ERFINV_A[i], _ERFINV_B[i])
                        + p * wt, p)
    for c in _ERFINV_A[len(_ERFINV_B):]:
        p = torch.where(lt625, p * wt + c, p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def _transform_kind(kind: int, b1: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """A row kind's float64 draw from its two threefry words."""
    if kind == UNIFORM32:
        return _f32_from_words(b1, b2)
    u = _f64_from_words(b1, b2)
    if kind == UNIFORM:
        return u
    if kind == NORMAL:
        u = torch.clamp(u * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
        return _SQRT2 * erf_inv(u)
    if kind == GUMBEL:
        u = torch.clamp(u + _TINY, min=_TINY)
        return -torch.log(-torch.log(u))
    raise LogicError(f"unknown draw kind {kind}")


# ---------------------------------------------------------------------------
# draw_standard: one launch for a table of rows.
# ---------------------------------------------------------------------------

@dataclass
class StandardTable:
    """Rows of one :func:`draw_standard` launch.  Each row is ``(key0,
    key1, kind, transform, stride, offset, col)`` and parameters ``(p0,
    p1)``."""

    rows: list = field(default_factory=list)
    params: list = field(default_factory=list)

    def add(self, key, kind: int, col: int, transform: int = NONE,
            p0: float = 0.0, p1: float = 0.0, stride: int = 1,
            offset: int = 0) -> int:
        k0, k1 = _as_key(key)
        self.rows.append((k0, k1, kind, transform, stride, offset, col))
        self.params.append((float(p0), float(p1)))
        return col

    def __len__(self) -> int:
        return len(self.rows)

    def tensors(self, device):
        rows = to_device(self.rows, device, _I64).reshape(-1, 7)
        params = to_device(self.params, device, _F64).reshape(-1, 2)
        return rows, params


def draw_standard_plain(table: StandardTable, out: torch.Tensor) -> None:
    """The kernel's draw in plain torch (any device): writes each row's
    column of ``out`` (``(n_trials, n_cols)`` float64)."""
    if not len(table):
        return
    device = out.device
    rows, params = table.tensors(device)
    n_trials = out.shape[0]
    kinds = rows[:, 2].tolist()
    block = _block(device)
    for kind in sorted(set(kinds)):
        sel = [r for r, k in enumerate(kinds) if k == kind]
        step = max(1, block // max(n_trials, 1))
        for g0 in range(0, len(sel), step):
            idx = torch.tensor(sel[g0:g0 + step], dtype=_I64, device=device)
            r = rows[idx]
            p = params[idx]
            t_step = max(1, block // len(idx))
            for t0 in range(0, n_trials, t_step):
                t = torch.arange(t0, min(t0 + t_step, n_trials), dtype=_I64,
                                 device=device)[:, None]
                flat = t * r[None, :, 4] + r[None, :, 5]
                b1, b2 = threefry_2x32((r[None, :, 0], r[None, :, 1]),
                                       *_counter(flat))
                x = _transform_kind(kind, b1, b2)
                tr = r[None, :, 3]
                p0, p1 = p[None, :, 0], p[None, :, 1]
                y = p0 + p1 * x
                x = torch.where(tr == AFFINE, y,
                                torch.where(tr == EXP_AFFINE, torch.exp(y),
                                            x))
                out[t[:, 0, None], r[None, :, 6]] = x


def draw_standard(table: StandardTable, out: torch.Tensor) -> torch.Tensor:
    """Fill the table's columns of ``out`` (``(n_trials, n_cols)``
    float64, contiguous): row ``(key, kind, transform, stride, offset,
    col)`` writes ``out[t, col] = transform(kind(bits(key, t * stride +
    offset)))``.  A CPU tensor runs :func:`draw_standard_plain`; a CUDA
    tensor launches ``csrc/prng.cu`` once or raises."""
    if out.dtype != _F64 or out.ndim != 2 or not out.is_contiguous():
        raise LogicError("draw_standard writes a contiguous 2-D float64 "
                         "block")
    if out.device.type != "cuda":
        draw_standard_plain(table, out)
        return out
    if not len(table) or out.shape[0] == 0:
        return out
    lib = load_library()
    rows, params = table.tensors(out.device)
    COUNTERS["launch.prng"] += 1
    code = lib.canopy_prng_draw_standard(
        rows.data_ptr(), params.data_ptr(), rows.shape[0], out.shape[0],
        out.shape[1], out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(lib, code, "prng draw_standard")
    return out


def _standard(key, shape, kind: int, device) -> torch.Tensor:
    """One standard draw of ``shape`` (row-major counters) through
    :func:`draw_standard`: one row per position of the last axis."""
    shape = tuple(shape)
    m = shape[-1] if shape else 1
    n = math.prod(shape[:-1]) if shape else 1
    out = torch.empty((n, m), dtype=_F64, device=torch.device(device))
    table = StandardTable()
    for j in range(m):
        table.add(key, kind, j, stride=m, offset=j)
    return draw_standard(table, out).reshape(shape)


def uniform(key, shape=(), dtype=torch.float64,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) (float32 or
    float64)."""
    if dtype not in (torch.float32, _F64):
        raise LogicError(f"uniform draws float32 or float64, not {dtype}")
    kind = UNIFORM if dtype == _F64 else UNIFORM32
    return _standard(key, shape, kind, device).to(dtype)


def normal(key, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float64."""
    return _standard(key, shape, NORMAL, device)


def gumbel(key, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float64 (mode "low")."""
    return _standard(key, shape, GUMBEL, device)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the index of the
    largest ``logits + gumbel(key, logits.shape)`` (the first on ties)."""
    noise = gumbel(key, logits.shape, logits.device)
    return torch.argmax(noise + logits.to(_F64), dim=axis)


# ---------------------------------------------------------------------------
# draw_gamma: _gamma_one per element.
# ---------------------------------------------------------------------------

def _uniform_at0(key):
    """A scalar ``uniform(key, ())`` per element key (counter (0, 0))."""
    return _f64_from_words(*threefry_2x32(key, 0, 0))


def _normal_at0(key):
    u = torch.clamp(_uniform_at0(key) * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2 * erf_inv(u)


def _gamma_alpha(keys, alpha: torch.Tensor, n: int) -> torch.Tensor:
    """``alpha`` broadcast to ``(len(keys), n)`` float64."""
    shape = (len(keys), n)
    try:
        return torch.broadcast_to(alpha.to(_F64), shape)
    except RuntimeError:
        raise LogicError(f"alpha of shape {tuple(alpha.shape)} does not "
                         f"broadcast to {shape}") from None


def draw_gamma_plain(keys, alpha: torch.Tensor, n: int,
                     log_space: bool = False) -> torch.Tensor:
    """The kernel's draw in plain torch (on ``alpha``'s device): one row of
    ``_gamma_impl`` over ``n`` elements per key, element ``i`` of row ``r``
    under ``split(keys[r], n)[i]``, ``alpha`` broadcast to ``(len(keys),
    n)``."""
    device = alpha.device
    shape = (len(keys), n)
    alpha = _gamma_alpha(keys, alpha, n).reshape(-1)
    words = torch.tensor([_as_key(k) for k in keys], dtype=_I64,
                         device=device).reshape(-1, 2)
    out = torch.empty(alpha.shape, dtype=_F64, device=device)
    step = _block(device)
    for f0 in range(0, out.numel(), step):
        f = torch.arange(f0, min(f0 + step, out.numel()), dtype=_I64,
                         device=device)
        row, i = f // max(n, 1), f % max(n, 1)
        ek = threefry_2x32((words[row, 0], words[row, 1]), *_counter(i))
        out[f0:f0 + f.numel()] = _gamma_one(ek, alpha[f0:f0 + f.numel()],
                                            log_space)
    return out.reshape(shape)


def _gamma_one(ek, alpha: torch.Tensor, log_space: bool) -> torch.Tensor:
    """``_gamma_one`` over elements with keys ``ek`` (two word tensors),
    the loops as masks over the elements still looping."""
    device = alpha.device
    n = alpha.numel()
    boost_mask = alpha >= 1.0
    a = torch.where(boost_mask, alpha, alpha + 1.0)
    d = a - 1.0 / 3.0
    # A Python float over a tensor is a reciprocal and a product in torch
    # (two roundings); a tensor numerator divides once, as XLA and the
    # kernel do.
    c = torch.full_like(d, 1.0 / 3.0) / torch.sqrt(d)
    inv_alpha = torch.ones_like(alpha) / alpha
    key_l = threefry_2x32(ek, 0, 0)
    subkey = threefry_2x32(ek, 0, 1)
    X = torch.zeros(n, dtype=_F64, device=device)
    V = torch.ones_like(X)
    U = torch.full_like(X, 2.0)

    def cond(X, V, U, d):
        return (U >= 1.0 - 0.0331 * (X * X)) & (
            torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))

    active = torch.nonzero(cond(X, V, U, d))[:, 0]
    while active.numel():
        k = (key_l[0][active], key_l[1][active])
        new_key = threefry_2x32(k, 0, 0)
        x_key = threefry_2x32(k, 0, 1)
        u_key = threefry_2x32(k, 0, 2)
        m = active.numel()
        x = torch.zeros(m, dtype=_F64, device=device)
        v = torch.full_like(x, -1.0)
        ca = c[active]
        redraw = torch.nonzero(v <= 0.0)[:, 0]
        while redraw.numel():
            kx = (x_key[0][redraw], x_key[1][redraw])
            nxt = threefry_2x32(kx, 0, 0)
            sub = threefry_2x32(kx, 0, 1)
            xr = _normal_at0(sub)
            x[redraw] = xr
            v[redraw] = 1.0 + xr * ca[redraw]
            x_key[0][redraw], x_key[1][redraw] = nxt
            redraw = redraw[v[redraw] <= 0.0]
        key_l[0][active], key_l[1][active] = new_key
        X[active] = x * x
        V[active] = (v * v) * v
        U[active] = _uniform_at0(u_key)
        active = active[cond(X[active], V[active], U[active], d[active])]
    u = _uniform_at0(subkey)
    if log_space:
        log_samples = torch.log1p(-u)
        log_boost = torch.where(boost_mask | (log_samples == 0.0), 0.0,
                                log_samples * inv_alpha)
        return (torch.log(d) + torch.log(V)) + log_boost
    # pow(1 - u, 1 / alpha) as exp(log(1 - u) / alpha), as the module says.
    boost = torch.where(boost_mask, 1.0,
                        torch.exp(torch.log(1.0 - u) * inv_alpha))
    return (d * V) * boost


def draw_gamma(keys, alpha: torch.Tensor, n: int,
               log_space: bool = False) -> torch.Tensor:
    """``(len(keys), n)`` draws of ``_gamma_impl``, row ``r`` under
    ``keys[r]`` (``alpha`` float64, broadcast to that shape; log-space
    draws with ``log_space``): a gamma deviate is one row, a beta deviate
    two.  A CPU tensor runs :func:`draw_gamma_plain`; a CUDA tensor
    launches ``csrc/prng.cu`` once or raises."""
    if alpha.device.type != "cuda":
        return draw_gamma_plain(keys, alpha, n, log_space)
    lib = load_library()
    device = alpha.device
    alpha = _gamma_alpha(keys, alpha, n).contiguous()
    words = to_device([_as_key(k) for k in keys], device,
                      _I64).reshape(-1, 2)
    out = torch.empty(alpha.shape, dtype=_F64, device=device)
    if out.numel() == 0:
        return out
    COUNTERS["launch.prng"] += 1
    code = lib.canopy_prng_draw_gamma(
        words.data_ptr(), words.shape[0], alpha.data_ptr(), n,
        int(log_space), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "prng draw_gamma")
    return out


def _gamma(key, a, shape, device, log_space: bool) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=_F64, device=torch.device(device))
    shape = tuple(a.shape) if shape is None else tuple(shape)
    flat = torch.broadcast_to(a, shape).reshape(1, -1)
    return draw_gamma([key], flat, flat.shape[1], log_space).reshape(shape)


def gamma(key, a, shape=None, device="cpu") -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` in float64."""
    return _gamma(key, a, shape, device, False)


def loggamma(key, a, shape=None, device="cpu") -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)`` in float64."""
    return _gamma(key, a, shape, device, True)


def beta(key, a, b, shape=None, device="cpu") -> torch.Tensor:
    """``jax.random.beta(key, a, b, shape)`` in float64: two log-gammas
    under ``split(key)``, normalised by their maximum."""
    dev = torch.device(device)
    a = torch.as_tensor(a, dtype=_F64, device=dev)
    b = torch.as_tensor(b, dtype=_F64, device=dev)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape)
                  if shape is None else shape)
    alphas = torch.stack([torch.broadcast_to(a, shape).reshape(-1),
                          torch.broadcast_to(b, shape).reshape(-1)])
    logs = draw_gamma(split(key), alphas, alphas.shape[1], log_space=True)
    return beta_from_logs(logs[0], logs[1]).reshape(shape)


def beta_from_logs(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """``_beta``'s ratio of two log-gamma draws, scaled by their maximum."""
    log_max = torch.maximum(log_a, log_b)
    ga = torch.exp(log_a - log_max)
    gb = torch.exp(log_b - log_max)
    return ga / (ga + gb)
