"""The plain reference on a tiny MEF model, held to brute force; its
threefry to the published known answers; its samples and probability on
the slice to the program's (the program only as a witness here: the
reference never imports it)."""

import itertools
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from canopy_bench.reference import Reference  # noqa: E402
from canopy_bench.reference.sampler import _threefry  # noqa: E402
from canopy_bench.reference.stats import top_stats  # noqa: E402

P = {"e1": 0.1, "e2": 0.2, "e3": 0.3, "e4": 0.4}

TINY = """<?xml version="1.0"?>
<opsa-mef>
  <define-fault-tree name="ft">
    <define-gate name="top"><or>
      <gate name="g1"/>
      <atleast min="2"><basic-event name="e2"/><basic-event name="e3"/>
        <basic-event name="e4"/></atleast>
    </or></define-gate>
    <define-gate name="g1"><and>
      <basic-event name="e1"/><basic-event name="e2"/></and></define-gate>
  </define-fault-tree>
  <model-data>
    <define-basic-event name="e1"><float value="0.1"/></define-basic-event>
    <define-basic-event name="e2"><float value="0.2"/></define-basic-event>
    <define-basic-event name="e3"><float value="0.3"/></define-basic-event>
    <define-basic-event name="e4"><lognormal-deviate><float value="0.4"/>
      <float value="3"/><float value="0.95"/></lognormal-deviate>
    </define-basic-event>
  </model-data>
</opsa-mef>
"""
EVENTS = ["e1", "e2", "e3", "e4"]


def top_of(x):
    return (x["e1"] and x["e2"]) or (x["e2"] + x["e3"] + x["e4"] >= 2)


def brute(p, fixed=None):
    total = 0.0
    for bits in itertools.product([0, 1], repeat=4):
        x = dict(zip(EVENTS, bits))
        if fixed:
            if any(x[k] != v for k, v in fixed.items()):
                continue
        w = 1.0
        for e in EVENTS:
            if fixed and e in fixed:
                continue
            w *= p[e] if x[e] else 1 - p[e]
        total += w * top_of(x)
    return total


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny.xml"
    path.write_text(TINY)
    return Reference([str(path)], "cpu")


def test_tops(tiny):
    assert tiny.tops() == [("ft", "top")]


def probability(reference, top, rows, dtype=torch.float64):
    """The reference's BDD on rows of basic-event probabilities (columns
    in the order of the reached events' names)."""
    from canopy_bench.reference.bdd import evaluate
    bdd, _names, columns = reference._top(top)
    return evaluate(bdd, rows, columns, dtype).to(torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_probability_is_exact(tiny, dtype):
    rows = torch.tensor([[P[e] for e in EVENTS]], dtype=torch.float64)
    got = float(probability(tiny, "top", rows.to(dtype), dtype)[0])
    tol = 1e-15 if dtype == torch.float64 else 1e-7
    assert got == pytest.approx(brute(P), rel=tol)


def test_every_row_is_exact(tiny):
    gen = torch.Generator().manual_seed(3)
    rows = torch.rand((64, 4), generator=gen, dtype=torch.float64)
    got = probability(tiny, "top", rows)
    for row, value in zip(rows.tolist(), got.tolist()):
        assert value == pytest.approx(brute(dict(zip(EVENTS, row))),
                                      rel=1e-14)
    # Events fixed to 1 and to 0 give the conditional probabilities.
    for e in EVENTS:
        k = EVENTS.index(e)
        for v in (0.0, 1.0):
            fixed = rows[:1].clone()
            fixed[0, k] = v
            p = dict(zip(EVENTS, rows[0].tolist()))
            assert float(probability(tiny, "top", fixed)[0]) == \
                pytest.approx(brute(p, {e: int(v)}), rel=1e-14)


def test_uncertainty_varies_only_the_deviate(tiny):
    stats = tiny.top_uncertainty("top", seed=5, n_trials=4096,
                                 num_quantiles=5, num_bins=4)
    assert stats["n_trials"] == 4096 and len(stats["quantiles"]) == 5
    assert stats["quantiles"][0] < stats["quantiles"][-1]
    again = tiny.top_uncertainty("top", seed=5, n_trials=4096,
                                 num_quantiles=5, num_bins=4)
    assert again == stats


def test_statistics_definitions():
    x = np.arange(1.0, 101.0)
    s = top_stats(x, num_quantiles=5, num_bins=4)
    assert s["quantiles"] == [1.0, 25.75, 50.5, 75.25, 100.0]
    assert s["histogram_edges"] == [1.0, 25.75, 50.5, 75.25, 100.0]
    assert s["std"] == pytest.approx(np.std(x, ddof=1))
    assert s["error_factor"] == pytest.approx(np.quantile(x, 0.95) / 50.5)


# Threefry-2x32 with 20 rounds: the known-answer vectors of Random123
# (Salmon et al., SC 2011): (key, counter) -> output.
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
        (0xC4923A9C, 0x483DF7A0))]


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_threefry_known_answers(key, ctr, out):
    assert _threefry(key[0], key[1], ctr[0], ctr[1]) == out
    t = torch.tensor([ctr[0]], dtype=torch.int64), \
        torch.tensor([ctr[1]], dtype=torch.int64)
    got = _threefry(key[0], key[1], *t)
    assert (int(got[0][0]), int(got[1][0])) == out


SLICE = os.path.join(BENCH, "models", "torch_slice_plant.xml")


@pytest.fixture(scope="module")
def slice_reference():
    return Reference([SLICE], "cpu")


def test_slice_against_the_program(slice_reference):
    """The program as a witness: same samples; the frozen exact
    probability at the means."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.compiler.graph import compile_fault_tree
    from canopy_tpu_torch.engine.uncertainty import \
        sample_basic_probabilities
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.ops.prng import prng_key
    from canopy_tpu_torch.settings import Settings
    import types
    model = Initializer([SLICE], Settings()).model
    (ft,) = list(model.fault_trees)
    ft.collect_top_events()
    (top,) = ft.top_events
    tree = compile_fault_tree(types.SimpleNamespace(name=ft.name,
                                                    top_events=[top]), top)
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    seed = 2**31 + 12345
    prog = sample_basic_probabilities(tape, prng_key(seed), 2048, 8760.0,
                                      "cpu")
    from canopy_bench.reference.sampler import lognormal_block, prng_key \
        as ref_key
    names = [e.id for e in tree.basic_events]
    ref = lognormal_block([slice_reference.model.basic[n] for n in names],
                          ref_key(seed), 2048, "cpu")
    assert torch.allclose(prog, ref, rtol=1e-9, atol=0)
    _bdd, names, _columns = slice_reference._top("synthetic-top")
    means = torch.tensor([[slice_reference.model.basic[n].mean
                           for n in names]], dtype=torch.float64)
    assert float(probability(slice_reference, "synthetic-top", means)[0]) \
        == pytest.approx(0.27682464038157023, rel=1e-12)
