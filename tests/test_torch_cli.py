"""Torch port, the CLI: ``python -m canopy_tpu_torch --device cpu`` against
the JAX package's CLI report, field for field.

Both CLIs run in-process with ``-o report.json``; the reports must be
equal after leaving out timings (wall clock).  Floats within 1e-12
relative (the same f64 operation order).  The sampled uncertainty block
is left out of the deterministic cases and compared in its own case: the
port's sampler keys its draws as the JAX package's does.
"""

import json
import math
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from canopy_tpu.cli import main as jax_main
from canopy_tpu_torch.cli import main as torch_main

from torch_parity import fixture_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strip(report: dict) -> dict:
    report = dict(report)
    report.pop("timings")
    for ft in report["fault_trees"]:
        ft.pop("uncertainty", None)
    return report


def _assert_same(got, want, path="report"):
    if isinstance(want, float) and isinstance(got, float):
        if math.isinf(want) or want == 0.0:
            assert got == want, path
        else:
            assert abs(got - want) <= 1e-12 * abs(want), (path, got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("flags", [
    ["--probability", "--importance"],
    ["--rare-event", "--probability"],
    ["--mcub", "--probability", "--importance"],
    ["--pdag", "--probability", "--importance"],
    # Cut-set paths (the products the sharded cut-set quantifier reads).
    ["--zbdd", "--probability"],
    ["--mocus", "--probability"],
    ["--prime-implicants", "--probability"],
    ["--limit-order", "3", "--probability"],
    ["--cut-off", "1e-4", "--probability"],
    ["--ccf", "--probability"],
    ["--preprocessor", "--probability"],
    ["--mocus", "--rare-event", "--probability"],
])
def test_report_matches_jax_cli(tmp_path, flags):
    model = fixture_path("aralia_like_small")
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    assert torch_main([model, "--device", "cpu", *flags,
                       "-o", str(ours)]) == 0
    assert jax_main([model, *flags, "-o", str(ref)]) == 0
    _assert_same(_strip(json.loads(ours.read_text())),
                 _strip(json.loads(ref.read_text())))


@pytest.mark.parametrize("flags", [
    ["--uncertainty", "--num-trials", "2000", "--seed", "7"],
    ["--uncertainty", "--num-trials", "2000", "--seed", "11",
     "--batch-size", "500"],
])
def test_report_with_uncertainty_matches_jax_cli(tmp_path, flags):
    """The whole report, uncertainty included, each CLI on its own
    sampler."""
    model = fixture_path("demo_plant")
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    assert torch_main([model, "--device", "cpu", "--probability", *flags,
                       "-o", str(ours)]) == 0
    assert jax_main([model, "--probability", *flags, "-o", str(ref)]) == 0
    got, want = json.loads(ours.read_text()), json.loads(ref.read_text())
    got.pop("timings")
    want.pop("timings")
    assert any(ft.get("uncertainty") for ft in want["fault_trees"])
    _assert_same(got, want)


def test_module_entry_point_and_xml_report(tmp_path):
    out = tmp_path / "report.xml"
    proc = subprocess.run(
        [sys.executable, "-m", "canopy_tpu_torch",
         fixture_path("aralia_like_small"), "--device", "cpu",
         "--probability", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    root = ET.parse(out).getroot()
    assert root.tag == "report"
    (analysis,) = root.iter("fault-tree-analysis")
    assert float(analysis.find("probability").get("value")) > 0.0
    assert root.find("information/software").get("name") == \
        "canopy-tpu-torch"


def test_profile_writes_a_torch_profiler_trace(tmp_path):
    prof = tmp_path / "prof"
    assert torch_main([fixture_path("aralia_like_small"), "--device", "cpu",
                       "--probability", "--profile", str(prof),
                       "-o", str(tmp_path / "r.json")]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    assert (prof / "ops.txt").read_text().strip()


#: A project file that breaks the project grammar (``num-trials`` is an
#: xsd positiveInteger).
BAD_PROJECT = ("<canopy-project><input-files><file>m.xml</file>"
               "</input-files><options><limits num-trials=\"0\"/>"
               "</options></canopy-project>")


#: A grammar using ``list``, which the port's RELAX NG interpreter does
#: not take.
LIST_GRAMMAR = ('<grammar xmlns="http://relaxng.org/ns/structure/1.0">'
                '<start><element name="opsa-mef"><list><text/></list>'
                '</element></start></grammar>')


@pytest.mark.parametrize("argv,needle", [
    (["--device", "cuda"], "cuda"),
    # --validate runs now (test_torch_relaxng.py::
    # test_validate_flag_exits_zero); the case keeps its id and checks that
    # a grammar outside the interpreter's RELAX NG subset exits 1.
    pytest.param(["--device", "cpu", "--validate", "list.rng"], "RELAX NG",
                 id="argv1-RELAX NG"),
    # The id is the one this case had when it checked --sil's refusal,
    # which named ROADMAP.md; --sil runs now
    # (test_torch_alignment_sil.py::test_cli_writes_sil_and_curve), and
    # --project too (test_torch_project.py), so the case checks that a
    # project file breaking the grammar exits 1 with the grammar's message.
    pytest.param(["--device", "cpu", "--project", "project.xml"],
                 "num-trials of element limits is not positiveInteger",
                 id="argv2-ROADMAP.md"),
])
def test_errors_exit_nonzero_with_a_message(capsys, tmp_path, monkeypatch,
                                            argv, needle):
    import torch
    if argv[1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "project.xml").write_text(BAD_PROJECT)
    (tmp_path / "list.rng").write_text(LIST_GRAMMAR)
    assert torch_main([fixture_path("aralia_like_small"), *argv]) == 1
    assert needle in capsys.readouterr().err
