"""Torch port, the MEF writer (``io/mef_writer.py``, on ``ElementTree``).

On every fixture:

* the port's output, parsed, is the JAX writer's element tree: the same
  tags, attributes (names, values and order), stripped text and order of
  children (exact equality);
* the port's output validates under the JAX package's MEF grammar
  (``canopy_tpu/schemas/mef.rng``, lxml's RELAX NG engine);
* parse, write and parse again through the port: every fault-tree and
  sequence probability of the port's analysis on the CPU within 1e-12
  relative of the original model's, and the same products.
"""

import xml.etree.ElementTree as ET

import pytest

from canopy_tpu.io.mef_writer import model_to_mef_xml as jax_writer
from canopy_tpu_torch.io.mef_writer import model_to_mef_xml

from torch_parity import ALL_FIXTURES, fixture_inputs, rel_err

RTOL = 1e-12


def _settings(pkg):
    import importlib
    settings = importlib.import_module(f"{pkg}.settings")
    return settings.Settings().probability_analysis(True).ccf_analysis(True)


def _model(pkg, name, settings=None):
    import importlib
    mef = importlib.import_module(f"{pkg}.mef")
    return mef.Initializer(fixture_inputs(name),
                           settings or _settings(pkg)).model


def _tree(element):
    return (element.tag, list(element.attrib.items()),
            (element.text or "").strip(),
            [_tree(child) for child in element])


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_element_tree_equals_the_jax_writer(name):
    ours = model_to_mef_xml(_model("canopy_tpu_torch", name))
    ref = jax_writer(_model("canopy_tpu", name))
    assert ours.startswith(b"<?xml version='1.0' encoding='UTF-8'?>\n")
    assert _tree(ET.fromstring(ours)) == _tree(ET.fromstring(ref))


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_output_validates_under_the_mef_grammar(name):
    from canopy_tpu.io.xml import Document, Validator
    from canopy_tpu.schemas import default_schema_path
    xml = model_to_mef_xml(_model("canopy_tpu_torch", name))
    Document.from_string(xml.decode(),
                         validator=Validator(default_schema_path()))


def _results(report):
    fault_trees = {(r.fault_tree, r.top_event, r.alignment, r.phase):
                   (r.probability, r.products)
                   for r in report.fault_trees}
    sequences = {s.sequence: s.probability for s in report.sequences}
    return fault_trees, sequences


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_quantification_survives_the_round_trip(name):
    from canopy_tpu_torch.engine.analysis import RiskAnalysis
    from canopy_tpu_torch.io.xml import Document
    from canopy_tpu_torch.mef import Initializer
    settings = _settings("canopy_tpu_torch")
    if name in ("aralia_like_nested_count", "torch_event_tree_plant"):
        settings.skip_products(True)    # MOCUS-scale products: minutes.
    model = _model("canopy_tpu_torch", name, settings)
    xml = model_to_mef_xml(model)
    reparsed = Initializer.from_documents(
        [Document.from_string(xml.decode())], settings).model
    ft, seq = _results(RiskAnalysis(model, settings, "cpu").run())
    ft2, seq2 = _results(RiskAnalysis(reparsed, settings, "cpu").run())
    assert ft.keys() == ft2.keys() and seq.keys() == seq2.keys()
    for key, (p, products) in ft.items():
        assert rel_err(ft2[key][0], p) <= RTOL, key
        assert ft2[key][1] == products, key
    for key, p in seq.items():
        assert rel_err(seq2[key], p) <= RTOL, key
