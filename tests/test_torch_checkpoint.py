"""Torch port, checkpointed sweeps (``engine/checkpoint.py``).

* The same deterministic ``batch_fn`` through both packages gives
  ``SweepState``s equal field by field (exact equality: the reservoir
  generator and its fast-forward are the JAX package's).
* A sweep stopped by an exception and resumed from its checkpoint equals
  the uninterrupted sweep, bit for bit, with a ``batch_fn`` that samples
  the slice plant's expression tape under the key ``fold_in(prng_key(seed),
  batch)`` and propagates its tops.
* A sweep checkpointed by the JAX package at batch 3 and resumed by the
  port: its state that of the uninterrupted JAX sweep (reservoir and sums
  within 1e-10 relative; the keys, hence the samples, are the same).
* A seed mismatch raises; ``SweepState.save`` / ``load`` round-trip.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canopy_tpu.engine.checkpoint import CheckpointedSweep as JaxSweep
from canopy_tpu_torch.engine.checkpoint import CheckpointedSweep, SweepState
from canopy_tpu_torch.ops.prng import fold_in, prng_key

from torch_parity import load_tree

CPU = torch.device("cpu")


def deterministic_batch(key, batch):
    return np.random.default_rng(1000 + batch).random(64)


def _assert_same_state(got, want):
    for field in dataclasses.fields(SweepState):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, field.name)
        else:
            assert a == b, field.name


def test_state_equals_the_jax_package(tmp_path):
    kw = dict(seed=5, n_batches=40, batch_trials=64, reservoir_size=512)
    _assert_same_state(CheckpointedSweep(deterministic_batch, **kw).run(),
                       JaxSweep(deterministic_batch, **kw).run())
    # Resumed half-way in the port, uninterrupted in the JAX package.
    path = str(tmp_path / "sweep.npz")
    CheckpointedSweep(deterministic_batch, checkpoint_path=path,
                      **dict(kw, n_batches=17)).run()
    resumed = CheckpointedSweep(deterministic_batch, checkpoint_path=path,
                                **kw).run()
    _assert_same_state(resumed, JaxSweep(deterministic_batch, **kw).run())


class _Stop(Exception):
    pass


def _tape_batch_fn(stop_at=None):
    """Batch ``b``: 256 samples of the slice plant's tape (lognormal
    parameters) under ``key``, their tops by the port's gather engine
    (f64, CPU)."""
    from canopy_tpu_torch.compiler.expr_tape import ExpressionTape
    from canopy_tpu_torch.engine.propagate import make_propagator
    _model, tree = load_tree("canopy_tpu_torch", "torch_slice_plant",
                             tree_name="slice")
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    propagate = make_propagator(tree, CPU)
    keys = []

    def batch_fn(key, batch):
        if batch == stop_at:
            raise _Stop(batch)
        keys.append(key)
        samples = tape.sample(key, 256, 8760.0, CPU)
        return propagate(torch.clamp(samples, 0.0, 1.0)).numpy()
    return batch_fn, keys


def test_resume_is_bit_identical(tmp_path):
    kw = dict(seed=11, n_batches=8, batch_trials=256, reservoir_size=700)
    fn, keys = _tape_batch_fn()
    full = CheckpointedSweep(fn, **kw).run()
    assert keys == [fold_in(prng_key(11), b) for b in range(8)]
    path = str(tmp_path / "sweep.npz")
    fn, _keys = _tape_batch_fn(stop_at=5)
    with pytest.raises(_Stop):
        CheckpointedSweep(fn, checkpoint_path=path, **kw).run()
    assert SweepState.load(path).completed_batches == 5
    fn, keys = _tape_batch_fn()
    resumed = CheckpointedSweep(fn, checkpoint_path=path, **kw).run()
    assert keys == [fold_in(prng_key(11), b) for b in range(5, 8)]
    _assert_same_state(resumed, full)
    assert full.completed_trials == 2048 and full.reservoir_filled == 700
    assert 0.0 < full.mean < 1.0 and full.std > 0.0


def _jax_tape_batch_fn(stop_at=None):
    """The JAX package's counterpart of :func:`_tape_batch_fn`: its tape
    under its key, its f64 propagation on its CPU backend."""
    from canopy_tpu.compiler.expr_tape import ExpressionTape as JaxTape
    from canopy_tpu.engine.propagate import top_event_probability
    _model, tree = load_tree("canopy_tpu", "torch_slice_plant",
                             tree_name="slice")
    tape = JaxTape.build([e.expression for e in tree.basic_events])
    house = jnp.asarray(tree.house_state_vector())

    def batch_fn(key, batch):
        if batch == stop_at:
            raise _Stop(batch)
        samples = jnp.clip(tape.sample(key, 256, 8760.0), 0.0, 1.0)
        return np.asarray(top_event_probability(tree, samples, house))
    return batch_fn


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A sweep stopped at batch 3 by the JAX package and resumed by the
    port reaches the uninterrupted JAX sweep's state: the same keys draw
    the same samples, so the reservoir (same slots filled by the shared
    reservoir generator) and the sums agree within 1e-10 relative."""
    kw = dict(seed=11, n_batches=5, batch_trials=256, reservoir_size=700)
    want = JaxSweep(_jax_tape_batch_fn(), **kw).run()
    path = str(tmp_path / "sweep.npz")
    with pytest.raises(_Stop):
        JaxSweep(_jax_tape_batch_fn(stop_at=3), checkpoint_path=path,
                 **kw).run()
    assert SweepState.load(path).completed_batches == 3
    fn, keys = _tape_batch_fn()
    got = CheckpointedSweep(fn, checkpoint_path=path, **kw).run()
    assert keys == [fold_in(prng_key(11), b) for b in range(3, 5)]
    assert (got.seed, got.completed_batches, got.completed_trials,
            got.reservoir_filled) == (want.seed, want.completed_batches,
                                      want.completed_trials,
                                      want.reservoir_filled)
    np.testing.assert_allclose(got.reservoir, want.reservoir, rtol=1e-10,
                               atol=0)
    for field in ("sum_", "sum_sq"):
        a, b = getattr(got, field), getattr(want, field)
        assert abs(a - b) <= 1e-10 * abs(b), field


def test_seed_mismatch_rejected(tmp_path):
    path = str(tmp_path / "sweep.npz")
    CheckpointedSweep(deterministic_batch, seed=1, n_batches=1,
                      batch_trials=64, checkpoint_path=path).run()
    with pytest.raises(ValueError):
        CheckpointedSweep(deterministic_batch, seed=2, n_batches=2,
                          batch_trials=64, checkpoint_path=path)


def test_statistics():
    state = CheckpointedSweep(deterministic_batch, seed=0, n_batches=50,
                              batch_trials=64).run()
    assert abs(state.mean - 0.5) < 0.02
    assert abs(state.std - np.sqrt(1 / 12)) < 0.02
    assert abs(state.quantiles([0.1, 0.5, 0.9])[1] - 0.5) < 0.05


def test_atomic_save_load(tmp_path):
    path = str(tmp_path / "s.npz")
    state = SweepState.fresh(seed=9)
    state.sum_ = 1.25
    state.completed_trials = 10
    state.save(path)
    loaded = SweepState.load(path)
    _assert_same_state(loaded, state)
    assert os.listdir(tmp_path) == ["s.npz"]    # No temporary file left.
