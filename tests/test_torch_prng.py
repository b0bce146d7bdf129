"""Torch port, ``ops/prng.py`` against ``jax.random`` (CPU, plain versions).

* Keys (``prng_key``, ``fold_in``, ``split``) and raw 32- and 64-bit bits
  equal ``jax.random``'s exactly, over seeds below and above 2^32 and
  negative ones.
* float32 and float64 uniforms, and the Bernoulli states of both
  packages' samplers, are bit-equal.
* Normals and lognormals within 1e-12 relative (``erf_inv``, ``log1p``
  and ``exp`` may round in the last bit otherwise than XLA's); ``erf_inv``
  itself within 1e-14 relative on every branch.
* Gamma (alpha 0.3, 1, 3.5 and per element), beta, Gumbel within 1e-12
  relative, log-gamma within 1e-12 absolute (a log: the gamma draw's
  relative error); categorical picks equal.  A trial past the tolerance
  is named in the failure, so a flipped rejection decision is reported,
  not absorbed.
* ``ExpressionTape.sample`` against the JAX tape on every fixture's basic
  events and on a list of every deviate kind (fixed and sampled
  parameters, histograms with sampled weights), within 1e-12 relative.
* ``draw_standard``'s table (strides, offsets, columns, transforms) and
  ``draw_gamma``'s rows against the public samplers.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.expr_tape import ExpressionTape as JaxTape
from canopy_tpu.engine.sampler import sample_states as jax_sample_states
from canopy_tpu.ops.bitpack import sample_states_packed as jax_packed
from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
from canopy_tpu_torch.engine.sampler import sample_states
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.ops import prng
from canopy_tpu_torch.ops.bitpack import sample_states_packed
from canopy_tpu_torch.utils.scale_models import every_deviate_kind

from torch_parity import ALL_FIXTURES, fixture_inputs

RTOL = 1e-12
SEEDS = [0, 7, 20261017, (1 << 32) + 5, (1 << 40) + 123, (1 << 63) - 1, -3]


def _close(got, want, rtol=RTOL, what=""):
    """Every element within ``rtol`` relative; names the worst elements."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    bad = ~(np.abs(got - want) <= rtol * np.abs(want))
    if bad.any():
        idx = np.argwhere(bad)[:5].tolist()
        pairs = [(i, float(got[tuple(i)]), float(want[tuple(i)]))
                 for i in idx]
        raise AssertionError(f"{what}: {int(bad.sum())} elements past "
                             f"{rtol}, first (index, port, jax): {pairs}")


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.prng_key(seed)
    assert ours == tuple(np.asarray(key).tolist())
    for data in (0, 1, 263, (1 << 31) + 3, (1 << 32) - 1):
        assert prng.fold_in(ours, data) == tuple(
            np.asarray(jax.random.fold_in(key, data)).tolist())
    assert prng.split(ours, 7) == [
        tuple(k) for k in np.asarray(jax.random.split(key, 7)).tolist()]
    np.testing.assert_array_equal(
        prng.random_bits(ours, 32, (9, 13)).numpy(),
        np.asarray(jax.random.bits(key, (9, 13), jnp.uint32)).astype(
            np.int64))
    np.testing.assert_array_equal(
        prng.random_bits(ours, 64, (4, 33)).numpy().view(np.uint64),
        np.asarray(jax.random.bits(key, (4, 33), jnp.uint64)))


def test_seed_outside_int64_raises():
    with pytest.raises(LogicError):
        prng.prng_key(1 << 63)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniforms_bit_equal(seed):
    key, ours = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            prng.uniform(ours, (37, 11), tdt).numpy(),
            np.asarray(jax.random.uniform(key, (37, 11), jdt)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bernoulli_states_equal_the_jax_package(dtype):
    p = np.random.default_rng(3).uniform(0.0, 1.0, 17)
    pt = torch.tensor(p, dtype=dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for seed in (1, 99):
        np.testing.assert_array_equal(
            sample_states(prng.prng_key(seed), pt, 640).numpy(),
            np.asarray(jax_sample_states(jax.random.PRNGKey(seed),
                                         jnp.asarray(p, jdt), 640)))
    np.testing.assert_array_equal(
        sample_states_packed(prng.prng_key(5), pt, 640).numpy(),
        np.asarray(jax_packed(jax.random.PRNGKey(5), jnp.asarray(p, jdt),
                              640)).view(np.int32))


def test_erf_inv_every_branch():
    rng = np.random.default_rng(11)
    # |x| near 1 reaches the w >= 6.25 and w >= 16 branches.
    x = np.concatenate([rng.uniform(-1.0, 1.0, 20_000),
                        1.0 - 10.0 ** rng.uniform(-16, -3, 2_000),
                        -(1.0 - 10.0 ** rng.uniform(-16, -3, 2_000)),
                        [0.0, 1.0, -1.0]])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    _close(got[finite], want[finite], 1e-14, "erf_inv")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_lognormal_gumbel(seed):
    key, ours = jax.random.PRNGKey(seed), prng.prng_key(seed)
    z = np.asarray(jax.random.normal(key, (4_000,)))
    _close(prng.normal(ours, (4_000,)).numpy(), z, what="normal")
    mu, sigma = -6.9, 1.1
    _close(torch.exp(mu + sigma * prng.normal(ours, (4_000,))).numpy(),
           np.asarray(jnp.exp(mu + sigma * jax.random.normal(key, (4_000,)))),
           what="lognormal")
    _close(prng.gumbel(ours, (40, 30)).numpy(),
           np.asarray(jax.random.gumbel(key, (40, 30))), what="gumbel")


@pytest.mark.parametrize("alpha", [0.3, 1.0, 3.5, "per-element"])
def test_gamma_and_loggamma(alpha):
    n = 3_000
    if alpha == "per-element":
        alpha = np.random.default_rng(2).uniform(0.05, 6.0, n)
    for seed in SEEDS[:3]:
        key, ours = jax.random.PRNGKey(seed), prng.prng_key(seed)
        want = np.asarray(jax.random.gamma(key, alpha, (n,)))
        _close(prng.gamma(ours, alpha, (n,)).numpy(), want,
               what=f"gamma seed {seed}")
        want = np.asarray(jax.random.loggamma(key, alpha, (n,)))
        got = prng.loggamma(ours, alpha, (n,)).numpy()
        bad = np.flatnonzero(~(np.abs(got - want) <= RTOL))
        assert not bad.size, (f"loggamma seed {seed}: trials {bad[:5]} "
                              f"port {got[bad[:5]]} jax {want[bad[:5]]}")


def test_beta_and_categorical():
    n = 3_000
    for seed in SEEDS[:3]:
        key, ours = jax.random.PRNGKey(seed), prng.prng_key(seed)
        _close(prng.beta(ours, 2.0, 6.0, (n,)).numpy(),
               np.asarray(jax.random.beta(key, 2.0, 6.0, (n,))), what="beta")
        a = np.random.default_rng(seed % 97).uniform(0.2, 4.0, n)
        _close(prng.beta(ours, a, 0.7).numpy(),
               np.asarray(jax.random.beta(key, a, 0.7)), what="beta a")
        logits = np.log(np.random.default_rng(seed % 89).uniform(
            1e-3, 1.0, (n, 6)))
        np.testing.assert_array_equal(
            prng.categorical(ours, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(key, logits, axis=-1)))


def test_draw_standard_table_layout():
    """Rows with strides, offsets, columns and transforms against the
    public samplers; untouched columns stay as they were."""
    key = prng.prng_key(42)
    k2 = prng.fold_in(key, 3)
    table = prng.StandardTable()
    table.add(key, prng.UNIFORM, 0)
    table.add(k2, prng.NORMAL, 2, prng.AFFINE, 5.0, 2.0)
    table.add(k2, prng.NORMAL, 3, prng.EXP_AFFINE, -1.0, 0.5)
    for b in range(3):
        table.add(key, prng.GUMBEL, 4 + b, stride=3, offset=b)
    table.add(key, prng.UNIFORM32, 7)
    out = torch.full((257, 8), -7.0, dtype=torch.float64)
    prng.draw_standard(table, out)
    np.testing.assert_array_equal(out[:, 0], prng.uniform(key, (257,)))
    assert bool((out[:, 1] == -7.0).all())
    z = prng.normal(k2, (257,))
    np.testing.assert_array_equal(out[:, 2], 5.0 + 2.0 * z)
    np.testing.assert_array_equal(out[:, 3], torch.exp(-1.0 + 0.5 * z))
    np.testing.assert_array_equal(out[:, 4:7], prng.gumbel(key, (257, 3)))
    np.testing.assert_array_equal(
        out[:, 7], prng.uniform(key, (257,), torch.float32).double())
    with pytest.raises(LogicError):
        prng.draw_standard(table, out.float())


def test_draw_gamma_rows():
    keys = prng.split(prng.prng_key(9), 2)
    alpha = torch.tensor([[0.4], [2.5]], dtype=torch.float64)
    out = prng.draw_gamma(keys, alpha, 500, log_space=True)
    for r in range(2):
        np.testing.assert_array_equal(
            out[r], prng.loggamma(keys[r], float(alpha[r, 0]), (500,)))
    with pytest.raises(LogicError):
        prng.draw_gamma(keys, torch.ones(3, dtype=torch.float64), 500)


def _every_kind(pkg):
    return every_deviate_kind(
        importlib.import_module(f"{pkg}.mef.expr"),
        importlib.import_module(f"{pkg}.mef.parameter").MissionTime())


@pytest.mark.parametrize("seed", [7, (1 << 33) + 1])
def test_tape_every_kind_matches_jax(seed):
    ours = ExpressionTape.build(_every_kind("canopy_tpu_torch"))
    ref = JaxTape.build(_every_kind("canopy_tpu"))
    got = ours.sample(prng.prng_key(seed), 2048, 8760.0, "cpu").numpy()
    want = np.asarray(ref.sample(jax.random.PRNGKey(seed), 2048, 8760.0))
    _close(got, want, what="every-kind tape")


def _basic_expressions(pkg, name):
    mef = importlib.import_module(f"{pkg}.mef")
    settings = importlib.import_module(f"{pkg}.settings")
    model = mef.Initializer(fixture_inputs(name),
                            settings.Settings().ccf_analysis(True)).model
    return [e.expression for e in model.basic_events if e.has_expression]


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_tape_fixture_basic_events_match_jax(name):
    ours = ExpressionTape.build(_basic_expressions("canopy_tpu_torch", name))
    ref = JaxTape.build(_basic_expressions("canopy_tpu", name))
    key = prng.fold_in(prng.prng_key(20261017), 2)
    got = ours.sample(key, 512, 8760.0, "cpu").numpy()
    want = np.asarray(ref.sample(jax.random.fold_in(
        jax.random.PRNGKey(20261017), 2), 512, 8760.0))
    _close(got, want, what=name)
