"""Torch port: every event-tree sequence's statistics reduced from one
sort of the (sequences, trials) matrix (``engine/sequences.py``,
``sequence_statistics``), row by row against NumPy's own calls: the 95 %
interval and the error factor to the bit, mean and ``std(ddof=1)`` within
1e-13 relative (``torch_parity.assert_sequence_stats``).

Matrices of one, two, an odd and an even number of trials, 4,097 and
2^16 trials; rows with ties; a row of zeros beside rows whose median is
zero (error factor ``inf``); and a served request on a small event tree
with a sequence that collects no formula (its trials all ones, its
method ``"expression"``).
"""

import numpy as np
import pytest
import torch

from canopy_tpu_torch.engine import sequences
from canopy_tpu_torch.engine.sequences import (compile_event_tree,
                                               sequence_statistics,
                                               sequence_uncertainty)
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings

from torch_parity import assert_sequence_stats

UNGATED = """<?xml version="1.0"?>
<opsa-mef name="ungated-sequence">
  <define-initiating-event name="LOOP" event-tree="Response"/>
  <define-event-tree name="Response">
    <define-functional-event name="F1"/>
    <define-sequence name="OK"/>
    <define-sequence name="Damage"/>
    <initial-state>
      <fork functional-event="F1">
        <path state="success"><sequence name="OK"/></path>
        <path state="failure">
          <collect-formula><gate name="g1"/></collect-formula>
          <sequence name="Damage"/>
        </path>
      </fork>
    </initial-state>
  </define-event-tree>
  <define-fault-tree name="Systems">
    <define-gate name="g1"><or>
      <basic-event name="a"/><basic-event name="b"/>
    </or></define-gate>
  </define-fault-tree>
  <model-data>
    <define-basic-event name="a"><lognormal-deviate><float value="0.02"/>
      <float value="3"/><float value="0.95"/></lognormal-deviate>
    </define-basic-event>
    <define-basic-event name="b"><lognormal-deviate><float value="0.1"/>
      <float value="3"/><float value="0.95"/></lognormal-deviate>
    </define-basic-event>
  </model-data>
</opsa-mef>
"""


def _lognormal(n_rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.lognormal(-9.0, 1.5, (n_rows, n))


def _ties(n_rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, (n_rows, n)) * 0.125 + 1e-3


def _zeros(n_rows: int, n: int, seed: int) -> np.ndarray:
    """A row of zeros, a row zero below its 60th percentile, and one of
    lognormal trials."""
    rows = _lognormal(n_rows, n, seed)
    rows[0] = 0.0
    rows[1, :int(0.6 * n)] = 0.0
    return rows


MATRICES = {
    "one_trial": (_lognormal, 3, 1),
    "two_trials": (_lognormal, 4, 2),
    "odd": (_lognormal, 5, 17),
    "even": (_lognormal, 5, 1000),
    "n4097": (_lognormal, 4, 4097),
    "n65536": (_lognormal, 2, 1 << 16),
    "ties_odd": (_ties, 4, 1001),
    "ties_even": (_ties, 4, 4096),
    "zeros": (_zeros, 3, 999),
}


def _served(tmp_path, monkeypatch):
    """A request on the ungated tree: the trials it reduced, and its
    result by outcome."""
    path = tmp_path / "ungated.xml"
    path.write_text(UNGATED)
    settings = Settings()
    model = Initializer([str(path)], settings).model
    (initiating,) = model.initiating_events
    compiled = compile_event_tree(model, initiating, settings, "cpu")
    captured = {}
    products = sequences._sequence_trials

    def capture(*args):
        captured.update(products(*args))
        return captured
    monkeypatch.setattr(sequences, "_sequence_trials", capture)
    out = sequence_uncertainty(compiled, 2**31 + 5, 3001)
    assert [o.sequence.name for o in compiled.outcomes] == ["OK", "Damage"]
    assert [out[k]["method"] for k in (0, 1)] == \
        ["expression", "bdd"]
    rows = torch.stack([captured[k] for k in (0, 1)]).numpy()
    assert (rows[0] == 1.0).all()
    return rows, [out[k] for k in (0, 1)]


@pytest.mark.parametrize("case", [*MATRICES, "ungated_sequence"])
def test_sequence_statistics_match_numpy(case, tmp_path, monkeypatch):
    if case == "ungated_sequence":
        rows, got = _served(tmp_path, monkeypatch)
        assert set(got[0]) == {"mean", "std", "ci95", "error_factor",
                               "n_trials", "method"}
    else:
        make, n_rows, n = MATRICES[case]
        rows = make(n_rows, n, seed=n)
        got = sequence_statistics(torch.from_numpy(rows))
        assert len(got) == n_rows
        assert all(set(g) == {"mean", "std", "ci95", "error_factor",
                              "n_trials"} for g in got)
    for g, row in zip(got, rows):
        assert_sequence_stats(g, row)
    if case == "zeros":
        assert [g["error_factor"] for g in got[:2]] == [np.inf, np.inf]
        assert got[0]["std"] == 0.0
