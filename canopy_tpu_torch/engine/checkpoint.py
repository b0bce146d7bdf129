"""Checkpoint/resume for long Monte-Carlo sweeps.

The JAX package's checkpointed batch loop (``canopy_tpu/engine/
checkpoint.py``): persist (seed, completed-batch counter, accumulated
moments, quantile sketch) after every batch, restart from the last
completed batch after a preemption.  Determinism comes for free: batch
``i`` always draws under the threefry key ``fold_in(prng_key(seed), i)``
(``ops/prng.py``), the JAX package's, so a resumed sweep produces
bit-identical results to an uninterrupted one.  :class:`SweepState` and
the keys are the JAX package's, so a sweep checkpointed by either package
resumes in the other to the same state.

The accumulator keeps exact moment sums plus a bounded reservoir sample
for quantiles/histograms (uniform over all seen trials), so memory stays
constant regardless of sweep length.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from ..ops.prng import fold_in, prng_key

__all__ = ["SweepState", "CheckpointedSweep"]


@dataclasses.dataclass
class SweepState:
    """Everything needed to resume a sweep."""

    seed: int
    completed_batches: int
    completed_trials: int
    sum_: float
    sum_sq: float
    reservoir: np.ndarray          # (k,) float64 uniform sample of results.
    reservoir_filled: int

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) so a crash never corrupts state."""
        directory = os.path.dirname(os.path.abspath(path))
        fd, tmp_path = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, seed=self.seed,
                         completed_batches=self.completed_batches,
                         completed_trials=self.completed_trials,
                         sum_=self.sum_, sum_sq=self.sum_sq,
                         reservoir=self.reservoir,
                         reservoir_filled=self.reservoir_filled)
            os.replace(tmp_path, path)
        except BaseException:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            raise

    @classmethod
    def load(cls, path: str) -> "SweepState":
        with np.load(path) as data:
            return cls(seed=int(data["seed"]),
                       completed_batches=int(data["completed_batches"]),
                       completed_trials=int(data["completed_trials"]),
                       sum_=float(data["sum_"]),
                       sum_sq=float(data["sum_sq"]),
                       reservoir=np.asarray(data["reservoir"]),
                       reservoir_filled=int(data["reservoir_filled"]))

    @classmethod
    def fresh(cls, seed: int, reservoir_size: int = 65536) -> "SweepState":
        return cls(seed=seed, completed_batches=0, completed_trials=0,
                   sum_=0.0, sum_sq=0.0,
                   reservoir=np.zeros(reservoir_size), reservoir_filled=0)

    # -- statistics --------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.sum_ / max(self.completed_trials, 1)

    @property
    def std(self) -> float:
        n = max(self.completed_trials, 2)
        return float(np.sqrt(max(
            (self.sum_sq - self.sum_ ** 2 / n) / (n - 1), 0.0)))

    def quantiles(self, qs) -> np.ndarray:
        sample = self.reservoir[:self.reservoir_filled]
        return np.quantile(sample, qs) if len(sample) else \
            np.zeros(len(qs))


class CheckpointedSweep:
    """Runs a batched sweep function with persistent, resumable state.

    ``batch_fn(key, batch_index) -> np.ndarray`` of per-trial results,
    ``key`` = ``fold_in(prng_key(seed), batch_index)``.
    """

    def __init__(self, batch_fn, seed: int, n_batches: int,
                 batch_trials: int, checkpoint_path: str | None = None,
                 checkpoint_every: int = 1, reservoir_size: int = 65536):
        self.batch_fn = batch_fn
        self.n_batches = n_batches
        self.batch_trials = batch_trials
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.state = SweepState.load(checkpoint_path)
            if self.state.seed != seed:
                raise ValueError(
                    f"checkpoint at {checkpoint_path} was created with "
                    f"seed {self.state.seed}, not {seed}")
        else:
            self.state = SweepState.fresh(seed, reservoir_size)

    def run(self) -> SweepState:
        base_key = prng_key(self.state.seed)
        rng = np.random.default_rng(self.state.seed ^ 0x5EED)
        # Fast-forward the reservoir RNG to the resume point so the
        # sample stays identical to an uninterrupted run.
        for batch in range(self.state.completed_batches):
            rng.random(self.batch_trials)

        k = len(self.state.reservoir)
        for batch in range(self.state.completed_batches, self.n_batches):
            key = fold_in(base_key, batch)
            results = np.asarray(self.batch_fn(key, batch), dtype=np.float64)
            assert results.shape == (self.batch_trials,)
            self.state.sum_ += float(results.sum())
            self.state.sum_sq += float((results ** 2).sum())
            # Reservoir sampling (Vitter's algorithm R, vectorized).
            u = rng.random(self.batch_trials)
            for i, value in enumerate(results):
                seen = self.state.completed_trials + i + 1
                if self.state.reservoir_filled < k:
                    self.state.reservoir[self.state.reservoir_filled] = value
                    self.state.reservoir_filled += 1
                elif u[i] < k / seen:
                    self.state.reservoir[int(u[i] * k) % k] = value
            self.state.completed_trials += self.batch_trials
            self.state.completed_batches = batch + 1
            if self.checkpoint_path and \
                    (batch + 1) % self.checkpoint_every == 0:
                self.state.save(self.checkpoint_path)
        if self.checkpoint_path:
            self.state.save(self.checkpoint_path)
        return self.state
