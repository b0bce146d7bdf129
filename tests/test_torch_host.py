"""Torch port, host layers: no jax, vendored copies, identical compilation.

* ``import canopy_tpu_torch`` (and every module on its main path) leaves
  ``jax`` out of ``sys.modules``, checked in a fresh interpreter.
* Drift guard: each host module the port vendors is the ``canopy_tpu``
  original apart from its import lines.  Two normalizations are allowed:
  upstream source paths in docstrings lose their machine prefix, and the
  native library's cache directory and log prefix name the port.  Modules
  copied definition by definition (project files, build info, compiled
  model I/O, the sweep state, Markov's host halves) are compared without
  docstrings, the port's package and program names normalized; the
  Markov host functions that hand tensors to the device differ from the
  originals in exactly the lines listed here.
* The port's compiled trees, modular BDDs and stream programs equal the
  JAX package's on every fixture, array for array.
* The standard-library XML reader builds the same element trees (names,
  attributes, text, source lines) as the lxml reader from every fixture.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import (ALL_FIXTURES, fixture_inputs, fixture_path,
                          load_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "canopy_tpu")
PORT_PKG = os.path.join(ROOT, "canopy_tpu_torch")

VENDORED = ["errors.py", "settings.py", "engine/event_tree_walk.py",
            "compiler/graph.py", "compiler/bdd.py", "compiler/zbdd.py",
            "compiler/cutsets.py", "compiler/prime_implicants.py",
            "compiler/schedule.py", "compiler/replay.py",
            "compiler/replay_adjoint.py", "compiler/spill.py",
            "compiler/reorder.py", "native/__init__.py",
            "native/build.py", "utils/synthetic.py"] + sorted(
    os.path.relpath(os.path.join(d, f), JAX_PKG)
    for d, _dirs, files in os.walk(os.path.join(JAX_PKG, "mef"))
    for f in files if f.endswith(".py"))


def test_import_leaves_jax_out():
    code = ("import sys, canopy_tpu_torch, canopy_tpu_torch.cli, "
            "canopy_tpu_torch.engine.analysis, "
            "canopy_tpu_torch.ops.adjoint_kernel, "
            "canopy_tpu_torch.ops.fused_kernel, "
            "canopy_tpu_torch.ops.replay_adjoint_kernel, "
            "canopy_tpu_torch.ops.bernoulli_kernel, "
            "canopy_tpu_torch.ops.bitpack, canopy_tpu_torch.engine.sampler, "
            "canopy_tpu_torch.ops.prng, "
            "canopy_tpu_torch.compiler.spill, "
            "canopy_tpu_torch.compiler.replay_adjoint, "
            "canopy_tpu_torch.compiler.reorder, "
            "canopy_tpu_torch.ops.block_gather, "
            "canopy_tpu_torch.ops.gather_kernel, "
            "canopy_tpu_torch.ops.bsr_propagate, "
            "canopy_tpu_torch.utils.synthetic, canopy_tpu_torch.report, "
            "canopy_tpu_torch.utils.scale_models, "
            "canopy_tpu_torch.project, canopy_tpu_torch.build_info, "
            "canopy_tpu_torch.schemas, canopy_tpu_torch.io.compiled_io, "
            "canopy_tpu_torch.io.mef_writer, "
            "canopy_tpu_torch.engine.checkpoint, "
            "canopy_tpu_torch.ops.markov, "
            "canopy_tpu_torch.utils.markov_models, "
            "canopy_tpu_torch.utils.profiling, "
            "canopy_tpu_torch.parallel, canopy_tpu_torch.parallel.mesh, "
            "canopy_tpu_torch.parallel.distributed, "
            "canopy_tpu_torch.parallel.quantify, "
            "canopy_tpu_torch.parallel.partition, "
            "canopy_tpu_torch.parallel.pipeline, "
            "canopy_tpu_torch.parallel.dryrun; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'canopy_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _without_imports(path: str) -> list[str]:
    with open(path) as fh:
        text = fh.read()
    lines = text.splitlines()
    drop = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno - 1, node.end_lineno))
    return [line for i, line in enumerate(lines) if i not in drop]


def _normalize(lines: list[str]) -> list[str]:
    return [re.sub(r"/\w+/reference/", "reference/", line)
            .replace("canopy_tpu_torch", "canopy_tpu")
            .replace("canopy-tpu-torch", "canopy-tpu") for line in lines]


@pytest.mark.parametrize("rel", VENDORED)
def test_vendored_module_is_the_original(rel):
    assert _normalize(_without_imports(os.path.join(PORT_PKG, rel))) == \
        _normalize(_without_imports(os.path.join(JAX_PKG, rel)))


def _definitions(path: str) -> dict[str, list[str]]:
    """A module's top-level functions, classes and assignments by name:
    their source lines, docstrings left out."""
    with open(path) as fh:
        text = fh.read()
    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
        else:
            continue
        drop = set()
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if (isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                drop.update(range(body[0].lineno - 1, body[0].end_lineno))
        start = min([node.lineno] + [d.lineno for d in
                                     getattr(node, "decorator_list", [])])
        out[name] = _normalize([line for i, line in enumerate(
            lines[start - 1:node.end_lineno], start - 1) if i not in drop])
    return out


#: Modules copied definition by definition, and the definitions that must
#: be the originals (``None``: every one of the module).
COPIED = {
    "project.py": ["Project", "load_project"],
    "build_info.py": ["_base_version", "_git", "build_info",
                      "version_string"],
    "io/compiled_io.py": None,
    "engine/checkpoint.py": ["SweepState"],
    "ops/markov.py": ["_poisson_terms", "_rcm_order"],
    "parallel/mesh.py": ["mesh_shape"],
    "parallel/quantify.py": ["_pad_rows"],
    "parallel/partition.py": ["_pad_rows", "_PaddedLevel", "_plan_levels"],
    "parallel/pipeline.py": ["_LevelCode", "_merge_level", "plan_stages"],
}


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copied_definitions_are_the_originals(rel):
    ours = _definitions(os.path.join(PORT_PKG, rel))
    theirs = _definitions(os.path.join(JAX_PKG, rel))
    names = COPIED[rel] or sorted(theirs)
    if COPIED[rel] is None:
        assert sorted(ours) == names
    for name in names:
        assert ours[name] == theirs[name], name


#: The Markov host functions that build the device half: their only
#: changes, as (the original's lines, the port's lines), stripped.
MARKOV_CHANGES = {
    "compile_blocked_triangular": [
        (["dtype=jnp.float64) -> BlockedTriangular:"],
         ["dtype=torch.float64, *,", "device) -> BlockedTriangular:"]),
        (["dense=jnp.asarray(dense, dtype=dtype),",
          "off_idx=jnp.asarray(off_idx),",
          "off_val=jnp.asarray(off_val, dtype=dtype),"],
         ["dense=torch.as_tensor(dense, dtype=dtype, device=device),",
          "off_idx=torch.as_tensor(off_idx, dtype=torch.int64, "
          "device=device),",
          "off_val=torch.as_tensor(off_val, dtype=dtype, device=device),"]),
    ],
    "triangular_solve_levels": [
        (["data: jnp.ndarray, diag: jnp.ndarray,",
          "b: jnp.ndarray) -> jnp.ndarray:"],
         ["data, diag, b: torch.Tensor) -> torch.Tensor:"]),
        (["np.asarray(indptr), np.asarray(indices), np.asarray(data),",
          "np.asarray(diag), lower=True)"],
         ["np.asarray(indptr), np.asarray(indices), _host(data),",
          "_host(diag), lower=True, device=b.device)"]),
    ],
    "sparse_lu": [
        (['block: int = 128, ordering: str = "rcm") -> SparseLU:'],
         ['block: int = 128, ordering: str = "rcm", *,',
          "device) -> SparseLU:"]),
        (["lower=True, block=block)"],
         ["lower=True, block=block, device=device)"]),
        (["lower=False, block=block)"],
         ["lower=False, block=block, device=device)"]),
    ],
}


@pytest.mark.parametrize("name", sorted(MARKOV_CHANGES))
def test_markov_host_functions_change_only_their_device_lines(name):
    import difflib
    ours = _definitions(os.path.join(PORT_PKG, "ops", "markov.py"))[name]
    theirs = _definitions(os.path.join(JAX_PKG, "ops", "markov.py"))[name]
    matcher = difflib.SequenceMatcher(a=theirs, b=ours, autojunk=False)
    changes = [([line.strip() for line in theirs[i1:i2]],
                [line.strip() for line in ours[j1:j2]])
               for tag, i1, i2, j1, j2 in matcher.get_opcodes()
               if tag != "equal"]
    assert changes == MARKOV_CHANGES[name]


def test_vendored_native_source_is_the_original():
    with open(os.path.join(PORT_PKG, "native", "bdd.cpp"), "rb") as a, \
            open(os.path.join(JAX_PKG, "native", "bdd.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_modules_builder_is_the_original():
    """``compiler/modules.py`` is vendored up to ``modular_probability``,
    the one function ported to torch."""
    def head(pkg):
        lines = _without_imports(os.path.join(pkg, "compiler", "modules.py"))
        return lines[:next(i for i, line in enumerate(lines)
                           if line.startswith("def modular_probability"))]
    assert head(PORT_PKG) == head(JAX_PKG)


def test_scalar_reference_is_the_original():
    """``compiler/_scalar_reference.py`` holds the JAX package's
    ``compiler/adjoint.py`` helpers that the vendored replay simulator
    imports, function for function."""
    def functions(path):
        with open(path) as fh:
            text = fh.read()
        return {node.name: ast.get_source_segment(text, node)
                for node in ast.parse(text).body
                if isinstance(node, ast.FunctionDef)}
    ours = functions(os.path.join(PORT_PKG, "compiler",
                                  "_scalar_reference.py"))
    theirs = functions(os.path.join(JAX_PKG, "compiler", "adjoint.py"))
    assert set(ours) == {"_f32", "_gate_scalar", "_bgate_partials"}
    for name, source in ours.items():
        assert source == theirs[name], name


def _assert_arrays_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def _compare_trees(jt, tt):
    for field in ("n_basic", "n_house", "n_gates", "basic_index",
                  "house_index", "gate_index", "top_index"):
        assert getattr(jt, field) == getattr(tt, field), field
    assert len(jt.levels) == len(tt.levels)
    for jl, tl in zip(jt.levels, tt.levels):
        jb, tb = list(jl.iter_blocks()), list(tl.iter_blocks())
        assert [k for k, _ in jb] == [k for k, _ in tb]
        for (_k, x), (_k2, y) in zip(jb, tb):
            for field, value in vars(x).items():
                _assert_arrays_equal(value, getattr(y, field), field)


def _compare_programs(jp, tp):
    assert jp.ops == tp.ops
    for field in ("n_basic", "n_basic_pad", "chunk_tiles", "n_chunks",
                  "pool_slots", "top_slot", "nnz", "n_house"):
        assert getattr(jp, field) == getattr(tp, field), field
    _assert_arrays_equal(jp.basic_perm, tp.basic_perm, "basic_perm")
    if jp.stage_cols is not None:
        _assert_arrays_equal(jp.stage_cols, tp.stage_cols, "stage_cols")


def _fault_trees(name):
    import canopy_tpu.mef as jmef
    import canopy_tpu.settings as jset
    model = jmef.Initializer(fixture_inputs(name),
                             jset.Settings().ccf_analysis(True)).model
    return [ft.name for ft in model.fault_trees]


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_compiled_structures_match(name):
    from canopy_tpu.compiler.bdd import BddBlowupError as JaxBlowup
    from canopy_tpu.compiler.modules import build_modular_bdd as jax_modular
    from canopy_tpu.compiler.schedule import (
        build_bdd_stream_schedule as jax_bdd_schedule,
        build_stream_schedule as jax_schedule)
    from canopy_tpu_torch.compiler.bdd import BddBlowupError
    from canopy_tpu_torch.compiler.modules import build_modular_bdd
    from canopy_tpu_torch.compiler.schedule import (
        build_bdd_stream_schedule, build_stream_schedule)
    for tree_name in _fault_trees(name):
        _jm, jt = load_tree("canopy_tpu", name, tree_name=tree_name)
        _tm, tt = load_tree("canopy_tpu_torch", name, tree_name=tree_name)
        _compare_trees(jt, tt)
        _compare_programs(jax_schedule(jt), build_stream_schedule(tt))
        try:
            jmod = jax_modular(jt, max_nodes=200_000)
        except JaxBlowup:
            with pytest.raises(BddBlowupError):
                build_modular_bdd(tt, max_nodes=200_000)
            continue
        tmod = build_modular_bdd(tt, max_nodes=200_000)
        assert (jmod.n_nodes, jmod.n_basic, jmod.top_index) == \
            (tmod.n_nodes, tmod.n_basic, tmod.top_index)
        for (jb, js), (tb, ts) in zip(jmod.chain, tmod.chain, strict=True):
            assert (js, jb.n_nodes, jb.root_ptr, jb.root) == \
                (ts, tb.n_nodes, tb.root_ptr, tb.root)
            for jl, tl in zip(jb.levels, tb.levels, strict=True):
                for x, y in zip(jl, tl, strict=True):
                    _assert_arrays_equal(x, y, "bdd level")
            if jb.n_nodes and jb.n_nodes <= 20_000:
                _compare_programs(jax_bdd_schedule(jb),
                                  build_bdd_stream_schedule(tb))


def _element_tree(element):
    return (element.name, element.line,
            sorted(element._node.attrib.items()), element.text(),
            [_element_tree(child) for child in element.children()])


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_stdlib_reader_matches_lxml_reader(name):
    from canopy_tpu.io.xml import Document as LxmlDocument
    from canopy_tpu_torch.io.xml import Document
    path = fixture_path(name)
    ours, ref = Document(path).root, LxmlDocument(path).root
    assert ours.filename == ref.filename
    assert _element_tree(ours) == _element_tree(ref)


def test_stdlib_reader_includes_and_reports_lines(tmp_path):
    from canopy_tpu_torch.errors import XmlParseError, XmlValidityError
    from canopy_tpu_torch.io.xml import Document
    inner = tmp_path / "inner.xml"
    inner.write_text("<inner\n val='5'/>")
    outer = tmp_path / "outer.xml"
    outer.write_text("<doc xmlns:xi='http://www.w3.org/2001/XInclude'>\n"
                     "<xi:include href='inner.xml'/><a x='y'/></doc>")
    root = Document(str(outer)).root
    assert root.child("inner").attribute("val", int) == 5
    assert root.child("inner").line == 1 and root.child("a").line == 2
    with pytest.raises(XmlValidityError) as err:
        root.child("a").attribute("x", int)
    assert err.value.line == 2
    with pytest.raises(XmlParseError) as err:
        Document.from_string("<doc>\n<unclosed></doc>")
    assert err.value.line == 2
