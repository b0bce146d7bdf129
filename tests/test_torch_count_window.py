"""Torch port, count gates: the count-DP forms every encoder shares.

``ops/stream_kernel.count_window`` gives a window ``[lo, hi]`` over ``n``
arguments its cheaper kernel form: upper-open (``hi >= n``) absorbing at
``lo`` (``lo + 1`` states), bounded (``hi + 2``), or the same over the
complemented arguments' window ``[n - hi, n - lo]``.  Every window has a
form: one beyond ``MAX_COUNT_STATES`` (``cardinality [130, 140]`` over
300 inputs, 142 states) runs its DP in a device-memory scratch on the
card and in the same plain versions here.

Tolerances: the forms round differently from the JAX package's DP (one
absorbing state at ``hi + 1``), so f64 values and gradients agree within
1e-12 relative of the JAX f64 gather engine and ``jax.grad``; the
float32 fused kernel's plain version within 1e-6; the 300-input gate's
stream adjoint within 1e-10 of torch autograd through the f64 plain
forward (both are f64, in different operation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canopy_tpu.mef.event as jev
from canopy_tpu.compiler.graph import compile_gates as jax_compile_gates
from canopy_tpu.engine.propagate import \
    top_event_probability as jax_top_probability
from canopy_tpu.mef.expr.constant import ConstantExpression as JConst
import canopy_tpu_torch.mef.event as tev
from canopy_tpu_torch.compiler.graph import compile_gates
from canopy_tpu_torch.engine.propagate import make_propagator
from canopy_tpu_torch.mef.expr.constant import ConstantExpression
from canopy_tpu_torch.ops import adjoint_kernel as tak
from canopy_tpu_torch.ops import fused_kernel as tfk
from canopy_tpu_torch.ops import stream_kernel as tsk

from torch_parity import load_tree

RTOL = 1e-12


def count_tree(ev, const, compile_fn, n: int, lo: int, hi: int | None):
    """One count gate over ``n`` basic events: ``atleast lo`` when ``hi``
    is None (the probe), else ``cardinality [lo, hi]`` with every fifth
    argument complemented."""
    events = []
    for i in range(n):
        e = ev.BasicEvent(f"c{i:03d}")
        e.expression = const(0.01)
        events.append(e)
    gate = ev.Gate("top")
    args = [ev.Arg(e, complement=hi is not None and i % 5 == 4)
            for i, e in enumerate(events)]
    if hi is None:
        gate.formula = ev.Formula(ev.Connective.ATLEAST, args, min_number=lo)
    else:
        gate.formula = ev.Formula(ev.Connective.CARDINALITY, args,
                                  min_number=lo, max_number=hi)
    tree = compile_fn([gate])
    tree.top_index = tree.gate_index["top"]
    return tree


def trees(n: int, lo: int, hi: int | None = None):
    return (count_tree(jev, JConst, jax_compile_gates, n, lo, hi),
            count_tree(tev, ConstantExpression, compile_gates, n, lo, hi))


def probe_inputs(n: int, n_trials: int = 8) -> np.ndarray:
    """p = 0.01 in the first trial (the probe), PRA-scale draws after."""
    p = np.random.default_rng(n).uniform(0.001, 0.03, (n_trials, n))
    p[0] = 0.01
    return p


def rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.mark.parametrize("lo,hi,n,form", [
    (2, 130, 130, (2, 130, False, 3)),     # atleast 2 of 130: upper-open
    (32, 86, 86, (32, 86, False, 33)),     # nested_count's top
    (128, 130, 130, (0, 2, True, 4)),      # atleast 128: count the false
    (125, 128, 130, (2, 5, True, 7)),      # bounded, complement cheaper
    (3, 5, 130, (3, 5, False, 7)),         # bounded, direct
    (120, 130, 130, (0, 10, True, 12)),    # open, complement cheaper
    (0, 2, 200, (0, 2, False, 4)),         # lo 0: direct bounded
    (7, 5, 10, (1, 0, False, 2)),          # empty window: value 0
])
def test_count_window_forms(lo, hi, n, form):
    assert tsk.count_window(lo, hi, n) == form


def test_residual_window_raises():
    """The residual window, a bounded one whose hi and n - lo both exceed
    126: cardinality [130, 140] of 300 keeps its direct 142-state form
    (the complement's [160, 170] needs 172), beyond the kernels' local
    arrays."""
    assert tsk.count_window(130, 140, 300) == (130, 140, False, 142)
    assert 142 > tsk.MAX_COUNT_STATES


def residual_inputs(n_trials: int = 8) -> np.ndarray:
    """p in [0.35, 0.55]: counts near 135, so P(count in [130, 140]) is
    about 0.4 and representable in float32 too."""
    return np.random.default_rng(300).uniform(0.35, 0.55, (n_trials, 300))


@pytest.mark.parametrize("entry", ["stream", "fused", "replay", "spill"])
def test_residual_window_raises_at_encode_time(entry):
    """cardinality [130, 140] over 300 inputs quantifies through every
    encoder and its plain version, f64, within 1e-12 relative of the JAX
    package's f64 gather engine; a CUDA propagator builds without a
    card."""
    jt, tt = trees(300, 130, 140)
    p = residual_inputs()
    want = np.asarray(jax_top_probability(jt, jnp.asarray(p)))
    h = torch.zeros(1, dtype=torch.float64)
    if entry == "stream":
        enc = tsk.tree_stream_encoding(tt)
        got = tsk.stream_forward(enc, _staged(enc, p), [])[0]
    elif entry == "fused":
        enc = tfk.encode_fused(tt)
        got = tfk.fused_forward_plain(enc, _staged(enc, p), h)
    elif entry == "replay":
        enc = tsk.encode_replay(tsk.compile_replay_stream(tt, grs_chunk=512))
        got = tsk.replay_forward(enc, tsk.stage_replay(
            enc, torch.from_numpy(p), torch.float64), [])[0]
    else:
        enc = tsk.encode_spill(tsk.compile_spill_stream(tt))
        got = tsk.spill_forward(enc, _staged(enc, p), [])
    assert enc.max_count_states == 142
    assert rel(got.numpy(), want) <= RTOL
    fn = make_propagator(tt, torch.device("cuda"), engine="stream")
    assert fn.engine == "stream"


def test_residual_window_gradient_matches_autograd():
    """The 300-input gate's stream adjoint (plain version, the
    leave-one-out DP over 141 states) against torch autograd through the
    f64 plain forward, and the level form bit-equal to the sequential
    walk."""
    _jt, tt = trees(300, 130, 140)
    enc = tsk.tree_stream_encoding(tt)
    staged = _staged(enc, residual_inputs(2))
    h = torch.zeros(1, dtype=torch.float64)
    ct = torch.tensor([1.0, 0.75], dtype=torch.float64)
    top, log = tsk.stream_forward_plain(enc, staged, h, True)
    grad = tak.stream_backward_plain(enc, staged, h, log, ct)
    s64 = staged.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tsk.stream_forward_plain(enc, s64, h)[0],
                                  s64, ct)
    scale = float(want.abs().max())
    assert float((grad - want).abs().max()) <= 1e-10 * scale
    assert torch.equal(
        tak.stream_backward_levels_plain(enc, staged, h, log, ct), grad)


def test_nested_count_top_needs_33_states():
    """aralia_like_nested_count's top, at least 32 of 86: 33 states
    absorbing at 32, not 88 (hi + 2 with hi the fan-in)."""
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_nested_count")
    for enc in (tfk.encode_fused(tree), tsk.tree_stream_encoding(tree)):
        top = enc.ops[enc.ops[:, 0] == tsk.COUNT][-1]
        assert (top[3] - top[2], top[4], top[5]) == (86, 32, 86)
        assert enc.max_count_states == 33


def _staged(enc, p: np.ndarray, dtype=torch.float64):
    return tsk.stage_basic(enc, torch.from_numpy(p), dtype)


@pytest.mark.parametrize("engine,lo,hi", [
    (engine, lo, hi) for lo, hi in [(2, None), (125, 128), (120, 130)]
    for engine in ("stream", "replay", "spill")] + [("fused", 2, None)])
def test_wide_count_engines_match_jax(engine, lo, hi):
    """130 inputs: each engine's plain version against the JAX f64
    gather engine (f64 engines 1e-12; the float32 fused kernel 1e-6, on
    the probe only: the cardinality windows' values, near 1e-240,
    underflow float32)."""
    jt, tt = trees(130, lo, hi)
    p = probe_inputs(130)
    want = np.asarray(jax_top_probability(jt, jnp.asarray(p)))
    if engine == "stream":
        enc = tsk.tree_stream_encoding(tt)
        got = tsk.stream_forward(enc, _staged(enc, p), [])[0]
    elif engine == "fused":
        assert tfk.fused_tiled_supported(tt)
        got = tfk.fused_propagate_tiled(tt, torch.from_numpy(p), [])
    elif engine == "replay":
        # The replay schedule's gate-stream ring must hold a 130-wide gate.
        enc = tsk.encode_replay(tsk.compile_replay_stream(tt, grs_chunk=256))
        got = tsk.replay_forward(enc, tsk.stage_replay(
            enc, torch.from_numpy(p), torch.float64), [])[0]
    else:
        enc = tsk.encode_spill(tsk.compile_spill_stream(tt))
        got = tsk.spill_forward(enc, _staged(enc, p), [])
    tol = 1e-6 if engine == "fused" else RTOL
    assert rel(got.numpy(), want) <= tol
    if lo == 2 and hi is None:
        assert abs(float(want[0]) - 0.3737098441591238) <= 1e-15


@pytest.mark.parametrize("lo,hi", [(2, None), (125, 128), (120, 130)])
def test_wide_count_gradient_matches_jax_grad(lo, hi):
    """The adjoint's plain version (upper-open partial P(c = lo - 1),
    complemented arguments' flipped signs) against jax.grad, f64."""
    jt, tt = trees(130, lo, hi)
    p = probe_inputs(130, 1)
    want = np.asarray(jax.grad(
        lambda q: jax_top_probability(jt, q).sum())(jnp.asarray(p)))
    enc = tsk.tree_stream_encoding(tt)
    bp = torch.from_numpy(p).requires_grad_(True)
    f = tak.make_differentiable_stream(enc, [])
    f(tsk.stage_basic(enc, bp, torch.float64)).sum().backward()
    got = bp.grad.numpy()
    scale = np.abs(want).max()
    assert float(np.abs(got - want).max()) <= RTOL * scale


def test_complement_form_flips_every_argument_flag():
    """cardinality [125, 128] of 130 counts the false arguments: [2, 5]
    with each argument's complement flag flipped."""
    _jt, tt = trees(130, 125, 128)
    enc = tsk.tree_stream_encoding(tt)
    (op,) = enc.ops[enc.ops[:, 0] == tsk.COUNT]
    flags = enc.args[op[2]:op[3], 2]
    assert (op[4], op[5]) == (2, 5)
    np.testing.assert_array_equal(flags, [i % 5 != 4 for i in range(130)])
    fused = tfk.encode_fused(tt)
    np.testing.assert_array_equal(fused.ops[:, 4:6], [[2, 5]])
    np.testing.assert_array_equal(fused.args[:, 2], flags)
