"""Torch port, compiled-model ``.npz`` files (``io/compiled_io.py``).

* Round trips in both directions: a file saved by either package loads
  in the other, with the same block arrays, index maps, house states and
  tape ops (exact equality).
* A loaded tree's f64 tops on the CPU are bit-equal to the original
  tree's (the port's gather engine on the same numpy inputs), whichever
  package wrote the file.
* A loaded tape's samples under a key ``fold_in(prng_key(seed), batch)``
  and its means are
  bit-equal to the unsaved tape's.
"""

import importlib

import numpy as np
import pytest
import torch

from canopy_tpu.io import compiled_io as jax_io
from canopy_tpu_torch.engine.propagate import top_event_probability
from canopy_tpu_torch.io import compiled_io as torch_io
from canopy_tpu_torch.ops.prng import fold_in, prng_key

CPU = torch.device("cpu")


def _model_with_everything(pkg):
    """``tests/test_compiled_io.py``'s model, built by package ``pkg``:
    a synthetic tree with atleast gates under an xor with a house event,
    one basic event lognormal; and the tape over its basic events."""
    synthetic = importlib.import_module(f"{pkg}.utils.synthetic")
    event = importlib.import_module(f"{pkg}.mef.event")
    deviate = importlib.import_module(f"{pkg}.mef.expr.random_deviate")
    constant = importlib.import_module(f"{pkg}.mef.expr.constant")
    graph = importlib.import_module(f"{pkg}.compiler.graph")
    tape_mod = importlib.import_module(f"{pkg}.compiler.expr_tape")
    top, events = synthetic.synthetic_mef_tree(
        n_basic=48, n_gates=32, fanin=4, seed=7, atleast_fraction=0.25)
    house = event.HouseEvent("maintenance", state=True)
    xor = event.Gate("xor-wrap")
    xor.formula = event.Formula(event.Connective.XOR,
                                [event.Arg(top), event.Arg(house)])
    C = constant.ConstantExpression
    events[0].expression = deviate.LognormalDeviate(C(1e-3), C(3.0),
                                                    C(0.95))
    tree = graph.compile_gates([xor])
    tree.top_index = tree.gate_index[xor.id]
    used = sorted((e for e in events if e.id in tree.basic_index),
                  key=lambda e: tree.basic_index[e.id])
    tape = tape_mod.ExpressionTape.build([e.expression for e in used])
    return tree, tape


def _assert_same_tree(got, want):
    for field in ("n_basic", "n_house", "n_gates", "basic_index",
                  "house_index", "gate_index", "top_index"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.house_state_vector(),
                                  want.house_state_vector())
    assert len(got.levels) == len(want.levels)
    for gl, wl in zip(got.levels, want.levels):
        gb, wb = list(gl.iter_blocks()), list(wl.iter_blocks())
        assert [k for k, _ in gb] == [k for k, _ in wb]
        for (_k, x), (_k2, y) in zip(gb, wb):
            for field, value in vars(y).items():
                np.testing.assert_array_equal(np.asarray(getattr(x, field)),
                                              np.asarray(value), field)


def _assert_same_tape(got, want):
    assert got._ops == want._ops
    assert (got._n_slots, got._out_slots, got.n_deviates) == \
        (want._n_slots, want._out_slots, want.n_deviates)


def _tops(tree, p):
    house = torch.as_tensor(tree.house_state_vector(), device=CPU)
    return top_event_probability(tree, torch.from_numpy(p), house).numpy()


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("torch", "jax"),
                                           ("jax", "torch")])
def test_round_trip(tmp_path, writer, reader):
    path = tmp_path / "model.npz"
    tree, tape = _model_with_everything("canopy_tpu_torch")
    jtree, jtape = _model_with_everything("canopy_tpu")
    # Both packages compile the model to the same arrays and tape ops.
    _assert_same_tree(tree, jtree)
    _assert_same_tape(tape, jtape)
    save = {"torch": torch_io.save_compiled,
            "jax": jax_io.save_compiled}[writer]
    load = {"torch": torch_io.load_compiled,
            "jax": jax_io.load_compiled}[reader]
    save(path, *((tree, tape) if writer == "torch" else (jtree, jtape)))
    loaded, loaded_tape = load(path)
    _assert_same_tree(loaded, tree)
    _assert_same_tape(loaded_tape, tape)
    assert [h.state for h in loaded.house_events] == [True]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_loaded_tree_tops_are_bit_equal(tmp_path, writer):
    path = tmp_path / "model.npz"
    if writer == "torch":
        tree, _tape = _model_with_everything("canopy_tpu_torch")
        torch_io.save_compiled(path, tree)
    else:
        jtree, _tape = _model_with_everything("canopy_tpu")
        jax_io.save_compiled(path, jtree)
        tree, _tape = _model_with_everything("canopy_tpu_torch")
    loaded, tape = torch_io.load_compiled(path)
    assert tape is None
    p = np.random.default_rng(0).uniform(0.0, 0.3, (16, tree.n_basic))
    np.testing.assert_array_equal(_tops(loaded, p), _tops(tree, p))


def test_loaded_tape_samples_are_bit_equal(tmp_path):
    tree, tape = _model_with_everything("canopy_tpu_torch")
    path = tmp_path / "model.npz"
    torch_io.save_compiled(path, tree, tape=tape)
    _loaded, tape2 = torch_io.load_compiled(path)
    np.testing.assert_array_equal(tape2.evaluate_mean(8760.0, CPU).numpy(),
                                  tape.evaluate_mean(8760.0, CPU).numpy())
    for key in [fold_in(prng_key(42), 0), fold_in(prng_key(42), 3)]:
        s1 = tape.sample(key, 64, 8760.0, CPU).numpy()
        s2 = tape2.sample(key, 64, 8760.0, CPU).numpy()
        np.testing.assert_array_equal(s2, s1)
    assert not np.array_equal(
        tape.sample(fold_in(prng_key(42), 1), 64, 8760.0, CPU),
        tape.sample(fold_in(prng_key(42), 0), 64, 8760.0, CPU))


def test_unknown_format_raises(tmp_path):
    from canopy_tpu_torch.errors import LogicError
    tree, _tape = _model_with_everything("canopy_tpu_torch")
    path = tmp_path / "model.npz"
    torch_io.save_compiled(path, tree)
    with np.load(path) as archive:
        arrays = dict(archive)
    arrays["__meta__"] = np.frombuffer(
        bytes(arrays["__meta__"]).replace(b'"format": 1', b'"format": 2'),
        dtype=np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(LogicError):
        torch_io.load_compiled(path)
