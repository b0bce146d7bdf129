"""Torch port, project files (``project.py``), ``--project`` and
``--version``.

* Grammar verdicts: every project document of ``tests/test_project.py``,
  one mutation per rule of the grammar, and the xsd lexical forms'
  edge cases; the port's RELAX NG interpreter on ``schemas/project.rng``
  (``io/xml.Validator``) must give lxml's RELAX NG verdict (the JAX
  package's ``Validator(project_schema_path())``) on each, exactly.
* ``load_project`` gives the same ``Project`` in both packages (input
  files, output, every settings field).
* ``--project`` through the port's CLI on ``--device cpu`` gives the
  report of the flag-driven run of the same model and options (equal
  after leaving out timings: the same device, seed and operation order);
  CLI flags override project options; a project that breaks the grammar
  exits 1 with the grammar's message.
* ``--version`` is ``canopy-tpu-torch <version>``, git-derived in a git
  checkout, with the JAX package's commit and count.
"""

import json
import os
import re
import shutil

import pytest

from canopy_tpu.errors import Error as JaxError
from canopy_tpu.io.xml import Document as JaxDocument
from canopy_tpu.io.xml import Validator as JaxValidator
from canopy_tpu.project import load_project as jax_load_project
from canopy_tpu.schemas import project_schema_path as jax_schema_path
from canopy_tpu_torch.cli import main
from canopy_tpu_torch.errors import Error, ValidityError
from canopy_tpu_torch.io.xml import Document, Validator
from canopy_tpu_torch.project import load_project
from canopy_tpu_torch.schemas import project_schema_path

from torch_parity import FIXTURES

# tests/test_project.py's documents.
PROJECT = """<?xml version="1.0"?>
<canopy-project>
  <input-files>
    <file>demo_plant.xml</file>
  </input-files>
  <options>
    <algorithm value="bdd"/>
    <analysis probability="true" importance="true" ccf="true"/>
    <limits num-trials="123" seed="9" mission-time="1000"/>
  </options>
  <output file="out/report.json"/>
</canopy-project>
"""
SCHEMA_VALID = """<?xml version="1.0"?>
<canopy-project>
  <input-files><file>m.xml</file></input-files>
  <options>
    <algorithm value="bdd"/>
    <analysis probability="true" importance="true"/>
    <limits limit-order="8" seed="3"/>
  </options>
</canopy-project>
"""
WRAP = ("<canopy-project><input-files><file>m.xml</file></input-files>"
        "%s</canopy-project>")
DOCUMENTS = {
    "project": PROJECT,
    "schema-valid": SCHEMA_VALID,
    "bad-algorithm": WRAP % '<options><algorithm value="quantum"/></options>',
    "unknown-element": WRAP % "<mystery/>",
    "no-inputs": "<canopy-project><input-files/></canopy-project>",
    # One mutation per rule of the grammar.
    "bad-root": "<not-a-project/>",
    "root-namespace": "<canopy-project xmlns='urn:x'><input-files><file>a"
                      "</file></input-files></canopy-project>",
    "empty-input-files": "<canopy-project><input-files> </input-files>"
                         "</canopy-project>",
    "file-without-text": "<canopy-project><input-files><file/>"
                         "</input-files></canopy-project>",
    "file-with-element": "<canopy-project><input-files><file><x/></file>"
                         "</input-files></canopy-project>",
    "two-files": "<canopy-project><input-files><file>a</file><file>b"
                 "</file></input-files></canopy-project>",
    "no-input-files": "<canopy-project><options/></canopy-project>",
    "text-in-root": "<canopy-project>t<input-files><file>a</file>"
                    "</input-files></canopy-project>",
    "root-attribute": "<canopy-project a='1'><input-files><file>a</file>"
                      "</input-files></canopy-project>",
    "file-attribute": "<canopy-project><input-files><file a='1'>a</file>"
                      "</input-files></canopy-project>",
    "unknown-attribute": WRAP % '<options><limits trials="5"/></options>',
    "namespaced-attribute": WRAP % '<options xmlns:q="urn:q" q:x="1"/>',
    "xml-lang": WRAP % '<options xml:lang="en"/>',
    "duplicate-algorithm": WRAP % ('<options><algorithm value="bdd"/>'
                                   '<algorithm value="zbdd"/></options>'),
    "options-interleaved": WRAP % ('<options><limits seed="1"/><analysis/>'
                                   '<approximation value="mcub"/>'
                                   '<algorithm value="pdag"/></options>'),
    "empty-options": WRAP % "<options/>",
    "two-options": WRAP % "<options/><options/>",
    "text-in-options": WRAP % "<options>x</options>",
    "tail-text": WRAP % "<options/>junk",
    "output-before-options": WRAP % '<output file="x"/><options/>',
    "two-outputs": WRAP % '<output file="a"/><output file="b"/>',
    "output-without-file": WRAP % "<output/>",
    "output-empty-file": WRAP % '<output file=""/>',
    "output-with-text": WRAP % '<output file="a">t</output>',
    "algorithm-without-value": WRAP % "<options><algorithm/></options>",
    "algorithm-with-text": WRAP % ('<options><algorithm value="bdd">x'
                                   '</algorithm></options>'),
    "algorithm-with-space": WRAP % ('<options><algorithm value="bdd"> '
                                    '</algorithm></options>'),
    "comment-and-pi": WRAP % "<!-- c --><?p q?><options/>",
}
VALUES = {
    "algorithm": ('<algorithm value="%s"/>',
                  ["bdd", "zbdd", "mocus", "pdag", "direct", " bdd ",
                   "b dd", "BDD", ""]),
    "approximation": ('<approximation value="%s"/>',
                      ["none", "rare-event", "mcub", "monte-carlo",
                       "\tnone\n", "rare event", "exact"]),
    "boolean": ('<analysis probability="%s"/>',
                ["true", "false", "1", "0", " true ", "yes", "TRUE", ""]),
    "nonNegativeInteger": ('<limits seed="%s"/>',
                           ["0", "7", "+3", " 3 ", "007", "-0", "-00", "-1",
                            "1e3", "", "+-1", "٣"]),
    "positiveInteger": ('<limits num-trials="%s"/>',
                        ["1", "+1", "0001", "0", "00", "-0", "+0", "1.0",
                         "99999999999999999999"]),
    "double": ('<limits cut-off="%s"/>',
               ["1e-10", "1.", ".5", "1E+3", " 1e3 ", "-1.5E-3", "+1",
                "INF", "-INF", "NaN", "+INF", "nan", "Infinity", ".",
                "1e", "1e+", ".e1", "x", "", "1 2", "0x10", "1_0",
                "١"]),
}
for kind, (template, values) in VALUES.items():
    for i, value in enumerate(values):
        DOCUMENTS[f"{kind}-{i}"] = WRAP % f"<options>{template % value}" \
                                          "</options>"


def _jax_verdict(text: str) -> bool:
    try:
        JaxDocument.from_string(text,
                                validator=JaxValidator(jax_schema_path()))
    except JaxError:
        return False
    return True


def _port_verdict(text: str) -> bool:
    try:
        Document.from_string(text, validator=Validator(project_schema_path()))
    except ValidityError:
        return False
    return True


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_grammar_verdict_equals_relax_ng(name):
    text = DOCUMENTS[name]
    assert _port_verdict(text) == _jax_verdict(text)


def test_grammar_error_names_file_and_line(tmp_path):
    path = tmp_path / "p.xml"
    path.write_text('<?xml version="1.0"?>\n<canopy-project>\n'
                    "  <input-files><file>m.xml</file></input-files>\n"
                    "  <options>\n"
                    '    <limits num-trials="0"/>\n'
                    "  </options>\n</canopy-project>\n")
    with pytest.raises(ValidityError) as err:
        load_project(str(path))
    assert err.value.filename == str(path) and err.value.line == 5
    assert "num-trials" in str(err.value)


def test_other_grammars_still_need_relax_ng(tmp_path):
    """The name is the one this test had when every grammar but the
    project grammar raised; the MEF grammar now loads and validates a
    fixture, and a grammar outside the interpreter's RELAX NG subset (or
    no grammar file at all) still raises ``IllegalOperation``."""
    from canopy_tpu_torch.errors import IllegalOperation
    from canopy_tpu_torch.schemas import default_schema_path
    Document(os.path.join(FIXTURES, "demo_plant.xml"),
             validator=Validator(default_schema_path()))
    listed = tmp_path / "list.rng"
    listed.write_text(
        '<grammar xmlns="http://relaxng.org/ns/structure/1.0"><start>'
        '<element name="r"><list><text/></list></element></start>'
        '</grammar>')
    for path in (str(listed), "__default__"):
        with pytest.raises(IllegalOperation, match="RELAX NG"):
            Validator(path)


def _settings_fields(settings) -> dict:
    return {k: str(v) for k, v in vars(settings).items()}


@pytest.fixture
def project_dir(tmp_path):
    shutil.copy(os.path.join(FIXTURES, "demo_plant.xml"),
                tmp_path / "demo_plant.xml")
    (tmp_path / "project.xml").write_text(PROJECT)
    (tmp_path / "out").mkdir()
    return tmp_path


@pytest.mark.parametrize("validate", [True, False])
def test_load_project_equals_the_jax_package(project_dir, validate):
    path = str(project_dir / "project.xml")
    ours = load_project(path, validate=validate)
    ref = jax_load_project(path, validate=validate)
    assert ours.input_files == ref.input_files == \
        [str(project_dir / "demo_plant.xml")]
    assert ours.output == ref.output == \
        str(project_dir / "out" / "report.json")
    assert _settings_fields(ours.settings) == _settings_fields(ref.settings)
    assert ours.settings.num_trials() == 123


@pytest.mark.parametrize("name", ["no-inputs", "file-without-text",
                                  "bad-root", "duplicate-algorithm"])
def test_bad_projects_raise_in_both(tmp_path, name):
    path = tmp_path / "p.xml"
    path.write_text(DOCUMENTS[name])
    with pytest.raises(JaxError):
        jax_load_project(str(path))
    with pytest.raises(Error):
        load_project(str(path))


SLICE_PROJECT = """<?xml version="1.0"?>
<canopy-project>
  <input-files><file>{model}</file></input-files>
  <options>
    <algorithm value="bdd"/>
    <analysis probability="true" importance="true" uncertainty="true"/>
    <limits num-trials="4096" seed="7"/>
  </options>
  <output file="project-report.json"/>
</canopy-project>
"""


def _strip_timings(path) -> dict:
    report = json.loads(path.read_text())
    report.pop("timings")
    return report


def test_cli_project_equals_flag_run(tmp_path):
    model = os.path.join(FIXTURES, "demo_plant.xml")
    (tmp_path / "p.xml").write_text(SLICE_PROJECT.format(model=model))
    assert main(["--project", str(tmp_path / "p.xml"), "--device",
                 "cpu"]) == 0
    flags = tmp_path / "flags.json"
    assert main([model, "--device", "cpu", "--bdd", "--probability",
                 "--importance", "--uncertainty", "--num-trials", "4096",
                 "--seed", "7", "-o", str(flags)]) == 0
    ours = _strip_timings(tmp_path / "project-report.json")
    assert ours == _strip_timings(flags)
    ft = ours["fault_trees"][0]
    assert ft["probability"] > 0 and ft["importance"]
    assert ft["uncertainty"]["n_trials"] == 4096


def test_cli_flags_override(project_dir, tmp_path):
    out = tmp_path / "o.json"
    assert main(["--project", str(project_dir / "project.xml"),
                 "--num-trials", "77", "--device", "cpu",
                 "-o", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["settings"]["num_trials"] == 77
    base = [r for r in payload["fault_trees"] if "alignment" not in r]
    assert base[0]["probability"] > 0 and base[0]["importance"]


def test_cli_without_inputs_errors(capsys):
    assert main(["--probability", "--device", "cpu"]) == 2
    assert "no input files (positional or --project)" in \
        capsys.readouterr().err


def test_version_is_git_derived(capsys):
    from canopy_tpu.build_info import build_info as jax_build_info
    from canopy_tpu_torch import build_info
    with pytest.raises(SystemExit) as exit_:
        main(["--version"])
    assert exit_.value.code == 0
    line = capsys.readouterr().out.strip()
    assert re.match(r"^canopy-tpu-torch ", line)
    info, ref = build_info(), jax_build_info()
    assert (info["commit"], info["commit_count"], info["source"]) == \
        (ref["commit"], ref["commit_count"], ref["source"])
    if info["source"] == "git":
        assert line == (f"canopy-tpu-torch {info['version']} (commit "
                        f"{info['commit']}, #{info['commit_count']})")
        assert re.match(r"^0\.3\.0\+g[0-9a-f]+(\.dirty)?$", info["version"])
    else:
        assert line == "canopy-tpu-torch 0.3.0"
