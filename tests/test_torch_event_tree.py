"""Torch port: event trees and sequence uncertainty.

Each case builds the same model in both packages from one MEF file, runs
``canopy_tpu``'s ``RiskAnalysis`` on the JAX CPU backend and the port's on
``"cpu"``, and compares the reports:

* sequences of ``hand_event_tree`` (also against its golden values),
  ``demo_plant``, ``station_blackout`` and the 64-sequence scale model, on
  the BDD forest path and on a forced direct-propagation fallback (each
  package's ``build_bdd_multi`` wrapped to pass ``max_nodes=2``): every
  ``SequenceResult`` field equal, probabilities within 1e-12 relative;
* the plant-width event tree (``torch_event_tree_plant.xml``) against its
  frozen JAX values within 1e-12 relative, on the fallback its forest
  takes by itself;
* sequence uncertainty on shared samples (each package's
  ``ExpressionTape.sample`` patched to return one numpy array): every
  summary statistic within 1e-12 relative on both paths; and on each
  package's own sampler, nothing patched (the same threefry keys), every
  sequence statistic within 1e-10 relative;
* the CLI's JSON and XML reports of ``hand_event_tree``.

Alignment phases, SIL and time curves: ``test_torch_alignment_sil.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canopy_tpu.compiler.bdd as jax_bdd
import canopy_tpu.compiler.expr_tape as jax_tape
import canopy_tpu_torch.compiler.bdd as port_bdd
import canopy_tpu_torch.compiler.expr_tape as port_tape
from canopy_tpu_torch.cli import main as cli_main
from canopy_tpu_torch.engine.analysis import RiskAnalysis
from canopy_tpu_torch.mef import Initializer
from canopy_tpu_torch.settings import Settings
from canopy_tpu_torch.utils.scale_models import event_tree_scale_xml

from torch_parity import (FIXTURES, fixture_inputs, fixture_path, rel_err,
                          run_both_analyses)

with open(f"{FIXTURES}/golden.json") as fh:
    GOLDEN = json.load(fh)
with open(f"{FIXTURES}/torch_event_tree_golden.json") as fh:
    PLANT_GOLDEN = json.load(fh)

#: Models written from the port's scale-model generator.
GENERATED = {"scale64": {},
             "scale16-deviates-house": {"n_fe": 4, "deviates": True,
                                        "house_flip": True}}


def _path(name, tmp_path):
    if name not in GENERATED:
        return fixture_path(name)
    path = tmp_path / f"{name}.xml"
    path.write_text(event_tree_scale_xml(**GENERATED[name]))
    return str(path)


@pytest.fixture
def forced_fallback(monkeypatch):
    """Every BDD forest of both packages gives up at its first node."""
    for module in (jax_bdd, port_bdd):
        original = module.build_bdd_multi

        def small(tree, root_slots, max_nodes=None, *args,
                  _original=original, **kwargs):
            return _original(tree, root_slots, 2, *args, **kwargs)
        monkeypatch.setattr(module, "build_bdd_multi", small)


def _assert_sequences_match(ours, ref, rtol=1e-12):
    assert len(ours.sequences) == len(ref.sequences) > 0
    for got, want in zip(ours.sequences, ref.sequences):
        assert (got.initiating_event, got.event_tree, got.sequence,
                got.states, got.linked_trees) == \
            (want.initiating_event, want.event_tree, want.sequence,
             want.states, want.linked_trees)
        assert rel_err(got.probability, want.probability) <= rtol, \
            (got.sequence, got.probability, want.probability)
        assert (got.uncertainty is None) == (want.uncertainty is None)


@pytest.mark.parametrize("path", ["forest", "fallback"])
@pytest.mark.parametrize("name", ["hand_event_tree", "demo_plant",
                                  "station_blackout", "scale64"])
def test_sequences_match_jax(name, path, tmp_path, request):
    if path == "fallback":
        request.getfixturevalue("forced_fallback")
    ours, ref = run_both_analyses(_path(name, tmp_path),
                          lambda s: s.probability_analysis(True))
    _assert_sequences_match(ours, ref)
    (ie,) = {s.initiating_event for s in ours.sequences}
    assert (f"propagation:{ie}" in ours.timings) == (path == "fallback")
    assert f"bdd-forest:{ie}" in ours.timings
    if name == "hand_event_tree":
        want = GOLDEN[name]["sequences"]
        got = {s.sequence: s.probability for s in ours.sequences}
        assert set(got) == set(want)
        for seq, value in want.items():
            assert rel_err(got[seq], value) <= 1e-12, seq
    if name == "scale64":
        assert len(ours.sequences) == 64


def test_plant_event_tree_against_its_golden():
    settings = Settings().skip_products(True)
    model = Initializer(fixture_inputs("torch_event_tree_plant"),
                        settings).model
    report = RiskAnalysis(model, settings, "cpu").run()
    ie = PLANT_GOLDEN["initiating_event"]
    assert f"propagation:{ie}" in report.timings  # The forest gave up.
    got = {s.sequence: s.probability for s in report.sequences}
    assert len(got) == PLANT_GOLDEN["n_sequences"] == 64
    for seq, want in PLANT_GOLDEN["sequences"].items():
        assert rel_err(got[seq], want) <= 1e-12, seq


def _shared_samples(n_trials, n_outputs):
    rng = np.random.default_rng(1000 + n_outputs)
    return rng.uniform(0.001, 0.3, (n_trials, n_outputs))


@pytest.fixture
def shared_samples(monkeypatch):
    """Both packages' tapes return the same numpy draws."""
    def port_sample(self, key, n_trials, mission_time, device):
        return torch.from_numpy(_shared_samples(n_trials, self.n_outputs)
                                ).to(device)

    def jax_sample(self, key, n_trials, mission_time):
        return jnp.asarray(_shared_samples(n_trials, self.n_outputs))
    monkeypatch.setattr(port_tape.ExpressionTape, "sample", port_sample)
    monkeypatch.setattr(jax_tape.ExpressionTape, "sample", jax_sample)


def _uncertainty(trials):
    def configure(s):
        s.probability_analysis(True).uncertainty_analysis(True)
        return s.num_trials(trials).seed(7).skip_products(True)
    return configure


@pytest.mark.parametrize("path", ["forest", "fallback"])
@pytest.mark.parametrize("name", ["demo_plant", "station_blackout",
                                  "scale16-deviates-house"])
def test_sequence_uncertainty_on_shared_samples(name, path, tmp_path,
                                                request, shared_samples):
    if path == "fallback":
        request.getfixturevalue("forced_fallback")
    ours, ref = run_both_analyses(_path(name, tmp_path), _uncertainty(2000))
    _assert_sequences_match(ours, ref)
    methods = set()
    for got, want in zip(ours.sequences, ref.sequences):
        unc, want_unc = got.uncertainty, want.uncertainty
        assert set(unc) == set(want_unc)
        assert (unc["n_trials"], unc["method"]) == \
            (want_unc["n_trials"], want_unc["method"])
        methods.add(unc["method"])
        for key in ("mean", "std", "error_factor"):
            assert rel_err(unc[key], want_unc[key]) <= 1e-12, key
        for a, b in zip(unc["ci95"], want_unc["ci95"]):
            assert rel_err(a, b) <= 1e-12
    assert methods == {"bdd" if path == "forest" else "direct-propagation"}


@pytest.mark.parametrize("name", ["demo_plant", "station_blackout",
                                  "scale16-deviates-house"])
def test_sequence_means_on_each_sampler(name, tmp_path):
    """Each package's own draws, nothing patched: the port keys its tape
    as the JAX package does (``fold_in(PRNGKey(seed), crc32(initiating
    event))``), so every sequence statistic agrees within 1e-10
    relative."""
    n = 20_000
    ours, ref = run_both_analyses(_path(name, tmp_path), _uncertainty(n))
    _assert_sequences_match(ours, ref)
    n_sampled = 0
    for got, want in zip(ours.sequences, ref.sequences):
        a, b = got.uncertainty, want.uncertainty
        assert (a is None) == (b is None), got.sequence
        if a is None:
            continue
        n_sampled += 1
        assert set(a) == set(b) and a["n_trials"] == b["n_trials"] == n
        for key in ("mean", "std", "error_factor"):
            assert rel_err(a[key], b[key]) <= 1e-10, (got.sequence, key)
        for x, y in zip(a["ci95"], b["ci95"]):
            assert rel_err(x, y) <= 1e-10, got.sequence
    assert n_sampled


def test_cli_reports_sequences(tmp_path, capsys):
    path = fixture_path("hand_event_tree")
    assert cli_main([path, "--device", "cpu", "--probability"]) == 0
    report = json.loads(capsys.readouterr().out)
    want = GOLDEN["hand_event_tree"]["sequences"]
    got = {s["sequence"]: s["probability"] for s in report["sequences"]}
    assert set(got) == set(want)
    for seq, value in want.items():
        assert rel_err(got[seq], value) <= 1e-12
    out = tmp_path / "report.xml"
    assert cli_main([path, "--device", "cpu", "-o", str(out)]) == 0
    text = out.read_text()
    for seq in want:
        assert f'<sequence name="{seq}"' in text
