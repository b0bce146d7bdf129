"""Torch port, bit-packed Monte Carlo on the CPU: packing, bitwise
propagation, popcount, the Philox sampler and the analysis branch.

The same numpy states go through the JAX package and the port.
Tolerances:

* ``pack_states``, ``propagate_packed`` (every node's words) and
  ``popcount_mean``: bit-equal to the JAX package (and/or/xor are exact);
* Philox4x32-10: Random123's known answers, exactly; one packed word's
  distinct products and XORs equal to the counts ``chip_smoke.py``
  bounds the kernel by;
* the plain Bernoulli sampler: its thresholds bit-equal to the JAX
  kernel's; ``p`` of 0 and 1 bit-equal to the JAX kernel in interpret mode
  (whose generator is a zero stub there, so no other draw compares);
  frequencies within 0.01 of ``p`` at 32 x 4096 trials; chunked draws
  bit-equal to one draw;
* ``RiskAnalysis`` Monte Carlo at 32 x 8192 trials within 6 sigma + 1e-4
  of every golden fault-tree anchor's exact probability (the band of
  ``tests/test_golden.py``); its standard error equal to the JAX formula's
  for the same estimate.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.compiler.graph import compile_gates
from canopy_tpu.engine.sampler import monte_carlo_ci as jax_monte_carlo_ci
from canopy_tpu.mef.event import (Arg, BasicEvent, Connective, Formula, Gate,
                                  HouseEvent)
from canopy_tpu.mef.expr import ConstantExpression
from canopy_tpu.ops import bitpack as jbp
from canopy_tpu.ops.pallas_kernels import \
    packed_bernoulli as jax_packed_bernoulli
from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.engine.sampler import (monte_carlo_ci, sample_states,
                                             sample_top_probability)
from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.ops import bitpack as tbp
from canopy_tpu_torch.ops.prng import prng_key
from canopy_tpu_torch.ops.bernoulli_kernel import (bernoulli_thresholds,
                                                   packed_bernoulli,
                                                   packed_bernoulli_plain,
                                                   philox4x32_10)
from canopy_tpu_torch.settings import Settings

from torch_parity import FAULT_TREE_FIXTURES, fixture_path, load_tree

with open(os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden.json")) as fh:
    GOLDEN = json.load(fh)
GOLDEN_TREES = sorted(n for n, g in GOLDEN.items()
                      if g.get("kind", "fault_tree") == "fault_tree")
#: Every fixture fault tree: (fixture, fault tree name).
FIXTURE_TREES = [(name, name) for name in FAULT_TREE_FIXTURES] + [
    ("demo_plant", "Cooling"), ("torch_slice_plant", "slice")]


def mixed_tree(with_house: bool):
    """``tests/test_bitpack.py``'s tree (every gate family, complements),
    optionally with a house event ANDed into the top's arguments."""
    events = []
    for i, p in enumerate([0.2, 0.4, 0.6, 0.3, 0.5, 0.7]):
        e = BasicEvent(f"e{i}")
        e.expression = ConstantExpression(p)
        events.append(e)
    g_and = Gate("g_and")
    g_and.formula = Formula(Connective.AND,
                            [Arg(events[0]), Arg(events[1], True)])
    g_xor = Gate("g_xor")
    g_xor.formula = Formula(Connective.XOR, [Arg(g_and), Arg(events[4])])
    g_atl = Gate("g_atl")
    g_atl.formula = Formula(Connective.ATLEAST,
                            [Arg(events[1]), Arg(events[2], True),
                             Arg(events[4]), Arg(events[5])], min_number=2)
    g_card = Gate("g_card")
    g_card.formula = Formula(Connective.CARDINALITY,
                             [Arg(events[0]), Arg(events[3]),
                              Arg(events[5])], min_number=1, max_number=2)
    top_args = [Arg(g_xor), Arg(g_atl, True), Arg(g_card)]
    if with_house:
        g_h = Gate("g_h")
        g_h.formula = Formula(Connective.AND,
                              [Arg(events[2]), Arg(HouseEvent("h", state=True))])
        top_args.append(Arg(g_h))
    top = Gate("top")
    top.formula = Formula(Connective.OR, top_args)
    tree = compile_gates([top])
    tree.top_index = tree.gate_index["top"]
    return tree


def random_states(n_trials: int, n_basic: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((n_trials, n_basic))
            < 0.5).astype(np.uint8)


def as_int32(words) -> np.ndarray:
    return np.asarray(words).view(np.int32)


def test_pack_states_matches_jax():
    states = random_states(96, 7, 0)
    want = as_int32(jbp.pack_states(jnp.asarray(states)))
    got = tbp.pack_states(torch.from_numpy(states))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(LogicError):
        tbp.pack_states(torch.zeros((33, 2)))


@pytest.mark.parametrize("house", [None, 1.0, 0.0])
def test_mixed_tree_propagation_matches_jax(house):
    tree = mixed_tree(with_house=house is not None)
    states = random_states(128, tree.n_basic, 1)
    hs = np.full(tree.n_house, house if house is not None else 0.0)
    packed = jbp.pack_states(jnp.asarray(states))
    want = as_int32(jbp.propagate_packed(tree, packed, jnp.asarray(hs)))
    got = tbp.propagate_packed(tree, tbp.pack_states(
        torch.from_numpy(states)), hs)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbp.popcount_mean(got, 128).numpy(),
        np.asarray(jbp.popcount_mean(jnp.asarray(want.view(np.uint32)),
                                     128)))


@pytest.mark.parametrize("fixture,tree_name", FIXTURE_TREES)
def test_fixture_propagation_matches_jax(fixture, tree_name):
    """Every node's words of every fixture tree (the nested-count anchor's
    753 count gates included), port tree against JAX tree."""
    _m, jtree = load_tree("canopy_tpu", fixture, tree_name=tree_name)
    _m, tree = load_tree("canopy_tpu_torch", fixture, tree_name=tree_name)
    states = random_states(64, tree.n_basic, 2)
    house = tree.house_state_vector()
    # Jitted: the JAX package's eager per-block dispatch takes 3x longer.
    jax_fn = jax.jit(lambda s, h: jbp.propagate_packed(
        jtree, jbp.pack_states(s), h))
    want = as_int32(jax_fn(jnp.asarray(states), jnp.asarray(house)))
    got = tbp.propagate_packed(tree, tbp.pack_states(
        torch.from_numpy(states)), house)
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (5, 40), dtype=np.uint64).astype(
        np.uint32)
    got = tbp.popcount(torch.from_numpy(words.view(np.int32)))
    want = [[bin(int(w)).count("1") for w in row] for row in words]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbp.popcount_mean(torch.from_numpy(words.view(np.int32)),
                          32 * 40).numpy(),
        np.asarray(jbp.popcount_mean(jnp.asarray(words), 32 * 40)))


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    zero = torch.zeros(1, dtype=torch.int64)
    full = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(v) for v in philox4x32_10((zero,) * 4, (zero, zero))]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    got = [int(v) for v in philox4x32_10((full,) * 4, (full, full))]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_word_work_matches_the_bound():
    """The integer work ``chip_smoke.py`` bounds the Philox kernel by.
    One packed word's eight calls (counters ``(w, j, seed_hi, 0)``, ``j``
    = 0..7, one key) are traced as expressions, so a product or XOR that
    the calls share counts once: 132 wide products and 146 three-input
    XORs, beside 32 compares; the trace computes philox4x32_10."""
    import chip_smoke
    from canopy_tpu_torch.ops.bernoulli_kernel import PHILOX_M, PHILOX_W
    mask = 0xFFFFFFFF
    w, seed_lo, seed_hi, event = 123_457, 7, 3, 11
    products, xors = set(), set()
    for j in range(8):
        # (expression, value) pairs; equal expressions are one operation.
        c = [(("w",), w), (("j", j), j), (("seed_hi",), seed_hi),
             (("0",), 0)]
        k = [(("k0", 0), seed_lo), (("k1", 0), event)]
        for r in range(10):
            if r:
                k = [(("k0", r), (k[0][1] + PHILOX_W[0]) & mask),
                     (("k1", r), (k[1][1] + PHILOX_W[1]) & mask)]
            halves = []
            for m, (expr, value) in ((PHILOX_M[0], c[0]),
                                     (PHILOX_M[1], c[2])):
                products.add((m, expr))
                halves.append(((("hi", m, expr), (m * value) >> 32),
                               (("lo", m, expr), (m * value) & mask)))
            (hi0, lo0), (hi1, lo1) = halves
            x0 = (("xor", hi1[0], c[1][0], k[0][0]),
                  hi1[1] ^ c[1][1] ^ k[0][1])
            x2 = (("xor", hi0[0], c[3][0], k[1][0]),
                  hi0[1] ^ c[3][1] ^ k[1][1])
            xors.update((x0[0], x2[0]))
            c = [x0, lo1, x2, lo0]
        assert [v for _e, v in c] == list(philox4x32_10(
            (w, j, seed_hi, 0), (seed_lo, event)))
    assert len(products) == chip_smoke.BERN_PRODUCTS_PER_WORD == 132
    assert len(xors) + 32 == chip_smoke.BERN_ALU_OPS_PER_WORD == 146 + 32


def test_thresholds_match_the_jax_kernel():
    p = np.array([0.0, 1.0, 0.5, 1e-12, 0.3, 1.0 - 1e-17, 1.0 - 2 ** -40,
                  -0.5, 1.5, 2 ** -33])
    p64 = jnp.clip(jnp.asarray(p), 0.0, 1.0)
    want = np.asarray(jnp.minimum(jnp.floor(p64 * 4294967296.0),
                                  4294967295.0).astype(jnp.uint32))
    got = bernoulli_thresholds(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_degenerate_probabilities_match_the_jax_kernel():
    p = np.array([0.0, 1.0])
    want = as_int32(jax_packed_bernoulli(0, jnp.asarray(p), 64,
                                         interpret=True))
    got = packed_bernoulli(0, torch.from_numpy(p), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == -1).all() and (got[0] == 0).all()


def test_bernoulli_frequencies():
    p = torch.tensor([0.05, 0.3, 0.5, 0.95], dtype=torch.float64)
    n_trials = 32 * 4096
    words = packed_bernoulli(7, p, n_trials)
    assert words.shape == (4, 4096) and words.dtype == torch.int32
    np.testing.assert_allclose(tbp.popcount_mean(words, n_trials).numpy(),
                               p.numpy(), atol=0.01)


def test_bernoulli_seeds_and_chunks():
    p = torch.tensor([0.4, 0.6, 0.2], dtype=torch.float64)
    a = packed_bernoulli(3, p, 32 * 100)
    assert torch.equal(a, packed_bernoulli(3, p, 32 * 100))
    assert not torch.equal(a, packed_bernoulli(4, p, 32 * 100))
    # A seed beyond 32 bits moves the counter, not the key's low word.
    assert not torch.equal(a, packed_bernoulli(3 + (1 << 32), p, 32 * 100))
    chunks = torch.cat([packed_bernoulli(3, p, 32 * 37),
                        packed_bernoulli(3, p, 32 * 63, word0=37)], dim=1)
    assert torch.equal(a, chunks)
    assert torch.equal(a, packed_bernoulli_plain(3, p, 32 * 100))
    with pytest.raises(LogicError):
        packed_bernoulli(3, p, 33)
    with pytest.raises(LogicError):
        packed_bernoulli(3, p, 64, word0=(1 << 32) - 1)


def test_chunked_top_probability_is_unchanged(monkeypatch):
    tree = mixed_tree(with_house=True)
    p = torch.tensor([0.2, 0.4, 0.6, 0.3, 0.5, 0.7], dtype=torch.float64)
    stats = {}
    one = tbp.packed_top_probability(tree, 5, p, 32 * 50, None, "cpu",
                                     stats=stats)
    assert stats["chunks"] == 1
    # A budget of 7 words' bytes: the same trials in 8 chunks.
    monkeypatch.setattr(tbp, "_CPU_CHUNK_BYTES",
                        7 * stats["bytes_per_word"])
    chunked = tbp.packed_top_probability(tree, 5, p, 32 * 50, None, "cpu",
                                         stats=stats)
    assert stats["chunks"] == 8 and one == chunked
    off = tbp.packed_top_probability(tree, 5, p, 32 * 50, [0.0], "cpu")
    assert off != one


def test_float_state_sampler():
    tree = mixed_tree(with_house=False)
    p = torch.tensor([0.2, 0.4, 0.6, 0.3, 0.5, 0.7], dtype=torch.float64)
    states = sample_states(prng_key(0), p, 1000)
    assert set(states.unique().tolist()) <= {0.0, 1.0}
    estimate, tops = sample_top_probability(tree, prng_key(1), p, 32 * 4096)
    # The float engine on 0/1 states is the Boolean function: its mean
    # is within 0.01 of the exact (gather on these independent-argument
    # gates is not exact, so compare with the packed engine's estimate).
    packed = tbp.packed_top_probability(tree, 1, p, 32 * 4096, None, "cpu")
    assert abs(float(estimate) - packed) < 0.01
    assert set(tops.unique().tolist()) <= {0.0, 1.0}
    words = tbp.sample_states_packed(prng_key(2), p, 32 * 4096)
    np.testing.assert_allclose(tbp.popcount_mean(words, 32 * 4096).numpy(),
                               p.numpy(), atol=0.01)


@pytest.mark.parametrize("name", GOLDEN_TREES)
def test_analysis_monte_carlo_agrees_with_golden(name):
    """The Monte Carlo branch of ``RiskAnalysis`` at 32 x 8192 trials.
    Products are skipped: MOCUS on the nested-count anchor does not end in
    minutes, and this test is about the estimate."""
    n = 32 * 8192
    settings = (Settings().probability_analysis(True)
                .approximation("monte-carlo").num_trials(n).seed(11)
                .skip_products(True).ccf_analysis(True))
    model = Initializer([fixture_path(name)], settings).model
    (ft,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    assert ft.method == "bdd/monte_carlo"
    exact = GOLDEN[name]["exact_probability"]
    stderr = (exact * (1 - exact) / n) ** 0.5
    assert abs(ft.probability - exact) < 6 * stderr + 1e-4
    assert ft.mc_std_error == monte_carlo_ci(ft.probability, n)
    assert ft.mc_std_error == float(jax_monte_carlo_ci(ft.probability, n))


def test_standard_error_formula_matches_jax():
    for estimate in (0.0, 1e-9, 0.05, 0.5, 0.987, 1.0):
        for n in (32, 65_536, 10_002_432):
            assert monte_carlo_ci(estimate, n) == \
                float(jax_monte_carlo_ci(estimate, n))
    t = monte_carlo_ci(torch.tensor(0.25, dtype=torch.float64), 64)
    assert float(t) == monte_carlo_ci(0.25, 64)


def test_analysis_monte_carlo_rounds_trials_to_words():
    settings = (Settings().probability_analysis(True)
                .approximation("monte-carlo").num_trials(1000).seed(2))
    model = Initializer([fixture_path("aralia_like_small")], settings).model
    (ft,) = RiskAnalysis(model, settings, "cpu").run().fault_trees
    _m, tree = load_tree("canopy_tpu_torch", "aralia_like_small")
    # The analysis samples the clamped mean vector, n rounded up to 1,024.
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    mean = torch.clamp(tape.evaluate_mean(settings.mission_time(), "cpu"),
                       0.0, 1.0)
    assert ft.probability == tbp.packed_top_probability(
        tree, 2, mean, 1024, None, "cpu")
    assert ft.mc_std_error == monte_carlo_ci(ft.probability, 1024)
