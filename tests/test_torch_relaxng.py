"""Torch port, RELAX NG validation (``io/xml.Validator``, a grammar
interpreter on the standard library) against lxml's RELAX NG engine.

* Verdicts equal lxml's on: every fixture, the port's MEF writer output
  of every fixture, the port's XML reports, and mutated documents of all
  three bundled grammars (a dropped required attribute, a bad xsd lexical
  form, elements out of order, an unknown element, stray text).
* Error lines: the port names the first node the grammar refuses (the
  element whose attribute is dropped or malformed, the unknown element,
  the element holding the stray text).  On the project grammar, which
  libxml2 validates without backtracking, that is lxml's reported line on
  every invalid document of ``tests/test_torch_project.py``.  In the MEF
  and report grammars' backtracking contexts libxml2 reports an enclosing
  element's child instead (its error stack, cut at 5 errors), so there
  the line is held to the mutation's site.
* A grammar construct outside the interpreter's subset raises
  ``IllegalOperation`` naming RELAX NG, when the grammar loads.
* ``python -m canopy_tpu_torch <fixture> --device cpu --validate`` exits
  0; an invalid input exits 1 with the file and line.
"""

import os
import re
import subprocess
import sys

import pytest
from lxml import etree

from canopy_tpu.schemas import default_schema_path as jax_mef_path
from canopy_tpu.schemas import project_schema_path as jax_project_path
from canopy_tpu.schemas import report_schema_path as jax_report_path
from canopy_tpu_torch.cli import main as torch_main
from canopy_tpu_torch.errors import IllegalOperation, ValidityError
from canopy_tpu_torch.io.xml import Document, Validator
from canopy_tpu_torch.schemas import (default_schema_path,
                                      project_schema_path,
                                      report_schema_path)

from torch_parity import ALL_FIXTURES, fixture_inputs, fixture_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAMMARS = {"mef": (default_schema_path(), jax_mef_path()),
            "report": (report_schema_path(), jax_report_path()),
            "project": (project_schema_path(), jax_project_path())}
_LXML: dict = {}
_PORT: dict = {}


def lxml_verdict(text: str, grammar: str) -> tuple[bool, int | None]:
    """lxml's verdict and the line of its last error (what the JAX
    package's ``Validator`` reports)."""
    if grammar not in _LXML:
        _LXML[grammar] = etree.RelaxNG(etree.parse(GRAMMARS[grammar][1]))
    rng = _LXML[grammar]
    ok = rng.validate(etree.fromstring(text.encode()).getroottree())
    return ok, None if ok else rng.error_log.last_error.line


def port_verdict(text: str, grammar: str) -> tuple[bool, int | None]:
    if grammar not in _PORT:
        _PORT[grammar] = Validator(GRAMMARS[grammar][0])
    try:
        Document.from_string(text, "doc.xml", validator=_PORT[grammar])
    except ValidityError as err:
        assert err.filename == "doc.xml" and str(err)
        return False, err.line
    return True, None


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _drop(text, tag, attr):
    m = re.search(rf'<{tag}\b[^>]*?(\s{attr}="[^"]*")', text)
    return m and (text[:m.start(1)] + text[m.end(1):], _line(text, m.start()))


def _lexical(text, tag, attr, bad):
    m = re.search(rf'<{tag}\b[^>]*?\s{attr}="([^"]*)"', text)
    return m and (text[:m.start(1)] + bad + text[m.end(1):],
                  _line(text, m.start()))


def _insert(text, tag, what):
    """``what`` right after the first start tag of ``tag``; the site is
    the inserted element's line, or for text the element holding it."""
    m = re.search(rf'<{tag}\b[^>]*?(?<!/)>', text)
    if not m:
        return None
    site = _line(text, m.end() if what.startswith("<") else m.start())
    return text[:m.end()] + what + text[m.end():], site


def _move_before(text, tag, before):
    """The first ``tag`` element moved in front of the first ``before``
    (elements out of order; no site: verdict only)."""
    m = re.search(rf"<{tag}\b.*?</{tag}>", text, re.S)
    b = re.search(rf"<{before}\b", text)
    if not (m and b) or b.start() > m.start():
        return None
    return (text[:b.start()] + m.group(0) + text[b.start():m.start()]
            + text[m.end():], None)


MEF_BASES = ["aralia_like_small", "aralia_like_ccf", "demo_plant",
             "hand_event_tree", "aralia_like_alignment", "station_blackout"]
MEF_MUTATIONS = [
    ("drop", ("define-gate", "name")), ("drop", ("define-basic-event", "name")),
    ("drop", ("basic-event", "name")), ("drop", ("gate", "name")),
    ("drop", ("define-fault-tree", "name")), ("drop", ("float", "value")),
    ("drop", ("define-CCF-group", "model")), ("drop", ("path", "state")),
    ("lexical", ("float", "value", "1e-x")),
    ("lexical", ("float", "value", "+INF")),
    ("lexical", ("float", "value", "1.5.2")),
    ("lexical", ("atleast", "min", "two")),
    ("lexical", ("atleast", "min", "-1")),
    ("lexical", ("int", "value", "1.5")),
    ("lexical", ("define-phase", "time-fraction", "half")),
    ("lexical", ("factor", "level", "0")),
    ("lexical", ("define-CCF-group", "model", "beta")),
    ("insert", ("define-fault-tree", "<bogus/>")),
    ("insert", ("define-gate", "<bogus/>")),
    ("insert", ("and", "<bogus/>")), ("insert", ("or", "<bogus/>")),
    ("insert", ("initial-state", "<bogus/>")),
    ("insert", ("define-CCF-group", "<bogus/>")),
    ("insert", ("define-fault-tree", "oops")),
    ("insert", ("define-gate", "oops")), ("insert", ("or", "oops")),
    ("insert", ("initial-state", "oops")),
    ("move", ("initial-state", "define-functional-event")),
    ("move", ("distribution", "members")),
    ("move", ("define-sequence", "define-functional-event")),
]
_MAKERS = {"drop": _drop, "lexical": _lexical, "insert": _insert,
           "move": _move_before}


def _mutations(bases, mutations, read) -> dict:
    cases = {}
    for base in bases:
        text = read(base)
        for kind, args in mutations:
            made = _MAKERS[kind](text, *args)
            if made:
                cases[f"{base}-{kind}-{'-'.join(args)}"] = made
    return cases


def _read_fixture(name):
    with open(fixture_path(name)) as fh:
        return fh.read()


MEF_CASES = _mutations(MEF_BASES, MEF_MUTATIONS, _read_fixture)


def test_bundled_grammars_are_the_jax_packages():
    for grammar in ("mef", "report"):
        ours, theirs = GRAMMARS[grammar]
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_fixture_verdicts(name):
    path = fixture_path(name)
    doc = etree.parse(path)
    doc.xinclude()
    want = etree.RelaxNG(etree.parse(jax_mef_path())).validate(doc)
    try:
        Document(path, Validator(default_schema_path()))
        got = True
    except ValidityError:
        got = False
    assert got == want


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_mef_writer_output_verdicts(name):
    from canopy_tpu_torch.io.mef_writer import model_to_mef_xml
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    model = Initializer(fixture_inputs(name), Settings().ccf_analysis(True)
                        ).model
    text = model_to_mef_xml(model).decode()
    text = text[text.index("\n") + 1:]          # lxml takes no declaration.
    assert port_verdict(text, "mef") == lxml_verdict(text, "mef") == \
        (True, None)


@pytest.mark.parametrize("case", sorted(MEF_CASES))
def test_mef_mutation_verdicts(case):
    text, site = MEF_CASES[case]
    got, want = port_verdict(text, "mef"), lxml_verdict(text, "mef")
    assert got[0] == want[0]
    if not got[0] and site is not None:
        assert got[1] == site


REPORTS = {"demo_plant": ["--probability", "--importance"],
           "aralia_like_small": ["--probability", "--importance",
                                 "--uncertainty", "--num-trials", "256"],
           "hand_event_tree": ["--probability"],
           "aralia_like_alignment": ["--probability", "--sil",
                                     "--time-step", "100"]}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = {}
    for name, flags in REPORTS.items():
        path = tmp_path_factory.mktemp("reports") / f"{name}.xml"
        assert torch_main([*fixture_inputs(name), "--device", "cpu", *flags,
                           "-o", str(path)]) == 0
        text = path.read_text()
        out[name] = text[text.index("\n") + 1:] if text.startswith("<?") \
            else text
    return out


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_verdicts(reports, name):
    assert port_verdict(reports[name], "report") == \
        lxml_verdict(reports[name], "report") == (True, None)


REPORT_MUTATIONS = [
    ("drop", ("probability", "value")), ("drop", ("basic-event", "name")),
    ("drop", ("software", "version")), ("drop", ("model", "name")),
    ("drop", ("fault-tree-analysis", "method")),
    ("drop", ("sequence", "value")), ("drop", ("product", "order")),
    ("insert", ("results", "<bogus/>")), ("insert", ("information", "oops")),
    ("insert", ("fault-tree-analysis", "<bogus/>")),
    ("insert", ("sum-of-products", "oops")),
    ("insert", ("fault-tree-analysis", '<probability value="1"/>')),
    ("move", ("results", "information")),
    ("move", ("model", "software")),
]


@pytest.mark.parametrize("base", sorted(REPORTS))
def test_report_mutation_verdicts(reports, base):
    """Every mutation the report has the elements for (at least 10)."""
    made = {f"{kind}-{'-'.join(args)}": _MAKERS[kind](reports[base], *args)
            for kind, args in REPORT_MUTATIONS}
    made = {key: case for key, case in made.items() if case}
    assert len(made) >= 10, sorted(made)
    for key, (text, site) in made.items():
        got, want = port_verdict(text, "report"), lxml_verdict(text,
                                                               "report")
        assert got[0] == want[0], key
        if not got[0] and site is not None and "probability" not in key:
            assert got[1] == site, key


def _project_documents() -> dict:
    import test_torch_project
    return dict(test_torch_project.DOCUMENTS)


PROJECT_DOCUMENTS = _project_documents()


@pytest.mark.parametrize("name", sorted(PROJECT_DOCUMENTS))
def test_project_lines_equal_lxml(name):
    """Verdict and reported line, as the JAX package reports them."""
    text = PROJECT_DOCUMENTS[name]
    text = text[text.index("\n") + 1:] if text.startswith("<?") else text
    assert port_verdict(text, "project") == lxml_verdict(text, "project")


GRAMMAR = ('<grammar xmlns="http://relaxng.org/ns/structure/1.0" '
           'datatypeLibrary="http://www.w3.org/2001/XMLSchema-datatypes">'
           '<start><element name="r">{}</element></start>{}</grammar>')


@pytest.mark.parametrize("body,defines", [
    ("<list><data type=\"integer\"/></list>", ""),
    ("<element><anyName/><empty/></element>", ""),
    ("<element><nsName ns=\"x\"/><empty/></element>", ""),
    ("<data type=\"integer\"><except><value>0</value></except></data>", ""),
    ("<mixed><empty/></mixed>", ""),
    ("<notAllowed/>", ""),
    ("<externalRef href=\"other.rng\"/>", ""),
    ("<data type=\"date\"/>", ""),
    ("<data type=\"integer\"><param name=\"minInclusive\">0</param></data>",
     ""),
    ("<ref name=\"d\"/>", "<define name=\"d\" combine=\"choice\"><empty/>"
                          "</define>"),
    ("<empty/>", "<include href=\"other.rng\"/>"),
    ("<empty/>", "<define name=\"unused\"><element name=\"u\"><list>"
                 "<text/></list></element></define>"),
])
def test_unsupported_construct_raises(tmp_path, body, defines):
    path = tmp_path / "g.rng"
    path.write_text(GRAMMAR.format(body, defines))
    with pytest.raises(IllegalOperation, match="RELAX NG"):
        Validator(str(path))


def test_supported_grammar_validates(tmp_path):
    path = tmp_path / "g.rng"
    path.write_text(GRAMMAR.format(
        '<attribute name="n"><data type="positiveInteger"/></attribute>'
        '<interleave><element name="a"><text/></element>'
        '<zeroOrMore><element name="b"><empty/></element></zeroOrMore>'
        '</interleave>', ""))
    v = Validator(str(path))
    Document.from_string('<r n="3"><b/><a>x</a><b/></r>', validator=v)
    with pytest.raises(ValidityError, match="is not positiveInteger"):
        Document.from_string('<r n="0"><a/></r>', validator=v)


def test_error_names_the_file_and_line(tmp_path):
    path = tmp_path / "bad.xml"
    path.write_text('<?xml version="1.0"?>\n<opsa-mef>\n'
                    '<define-fault-tree name="f">\n'
                    '<define-gate name="g"><and>\n'
                    '<basic-event name="a"/>\n<bogus/>\n</and></define-gate>\n'
                    '</define-fault-tree>\n</opsa-mef>\n')
    with pytest.raises(ValidityError) as err:
        Document(str(path), Validator(default_schema_path()))
    assert err.value.filename == str(path) and err.value.line == 6
    assert "bogus" in str(err.value)


def test_validate_flag_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "canopy_tpu_torch",
         fixture_path("aralia_like_small"), "--device", "cpu", "--validate",
         "--probability", "-o", os.devnull],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_validate_flag_refuses_an_invalid_input(tmp_path, capsys):
    path = tmp_path / "bad.xml"
    path.write_text(_read_fixture("aralia_like_small").replace(
        '<define-gate name="sg28">', '<define-gate>'))
    assert torch_main([str(path), "--device", "cpu", "--validate"]) == 1
    err = capsys.readouterr().err
    assert "define-gate" in err and f"{path}:" in err
