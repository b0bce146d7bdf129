"""Write the frozen ``jax.random`` reference of the port's sampler.

The machine with the card has no JAX, so ``chip_smoke.py`` (phase
``prng``) and ``tests/test_torch_analysis.py`` read the JAX package's
draws and uncertainty blocks from ``tests/fixtures/torch_prng_golden.json``,
which this script writes with the JAX package in f64 on the CPU:

* ``draws``: under ``fold_in(PRNGKey(SEED), 263)``, a ``(2^20,)`` draw of
  32- and 64-bit bits, float64 and float32 uniforms, normals and Gumbel
  noise, at ``INDICES``;
* ``gamma``: ``jax.random.gamma`` at alpha 0.3 and 3.5 and ``beta(2, 6)``
  over ``GAMMA_N`` elements, at ``GAMMA_INDICES``;
* ``slice_samples``: the slice plant's expression tape (its compiled
  tree's basic events, in order) sampled under ``PRNGKey(SEED)`` at 2^20
  trials, at ``SLICE_PAIRS`` (trial, column);
* ``slice_uncertainty``: the uncertainty block of the JAX CLI on the slice
  (``--bdd --uncertainty --num-trials 16384 --batch-size 8192 --seed
  7``).  16,384 trials, not 2^20 or 65,536: the JAX BDD uncertainty path
  on a CPU takes about 50 ms a trial (823 s at 16,384 trials; a 65,536-trial
  run had not ended after 35 minutes), and an unbatched run of 65,536
  trials grew past 20 GB of host memory;
* ``slice_uncertainty_4096``: ``RiskAnalysis`` of the slice (bdd,
  probability, CCF, 4,096 uncertainty trials, seed 7), unbatched and with
  ``batch_size(1000)``, for the CPU parity test (the JAX run takes about
  four minutes on a CPU, too long for the test).

Run from the repository root (about 25 minutes on a CPU; each stage is
written when it is done, and ``--resume`` skips the stages the file
holds):

    JAX_PLATFORMS=cpu python tools/make_torch_prng_golden.py [--resume]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from canopy_tpu.cli import main as jax_cli  # noqa: E402
from canopy_tpu.compiler.expr_tape import ExpressionTape  # noqa: E402
from canopy_tpu.compiler.graph import compile_fault_tree  # noqa: E402
from canopy_tpu.engine.analysis import RiskAnalysis  # noqa: E402
from canopy_tpu.mef import Initializer  # noqa: E402
from canopy_tpu.settings import Settings  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MODEL_PATH = os.path.join(FIXTURES, "torch_slice_plant.xml")
GOLDEN_PATH = os.path.join(FIXTURES, "torch_prng_golden.json")

SEED = 7
DRAW_N = 1 << 20
INDICES = [0, 1, 2, 31, 32, 1000, 65535, 65536, 524287, 777777, DRAW_N - 1]
GAMMA_N = 65_536
GAMMA_INDICES = [0, 1, 2, 777, 4095, 40000, GAMMA_N - 1]
SLICE_TRIALS = 1 << 20
SLICE_PAIRS = [(t, c) for t in (0, 1, 4097, 65535, 524288, SLICE_TRIALS - 1)
               for c in (0, 1, 131, 200, 262)]
UNC_TRIALS = 16_384
UNC_BATCH = 8_192
UNC_FLAGS = ["--bdd", "--uncertainty", "--num-trials", str(UNC_TRIALS),
             "--batch-size", str(UNC_BATCH), "--seed", str(SEED)]
TEST_TRIALS = 4_096
TEST_BATCH = 1_000


def _key(key) -> list[int]:
    return [int(k) for k in np.asarray(key)]


def _floats(x, idx) -> list[float]:
    return [float(v) for v in np.asarray(x)[idx]]


def draws() -> dict:
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 263)
    shape = (DRAW_N,)
    return {
        "key": _key(key), "n": DRAW_N, "indices": INDICES,
        "bits32": [int(v) for v in np.asarray(
            jax.random.bits(key, shape, jnp.uint32))[INDICES]],
        "bits64": [int(v) for v in np.asarray(
            jax.random.bits(key, shape, jnp.uint64))[INDICES]],
        "uniform_f64": _floats(jax.random.uniform(key, shape, jnp.float64),
                               INDICES),
        "uniform_f32": _floats(jax.random.uniform(key, shape, jnp.float32),
                               INDICES),
        "normal": _floats(jax.random.normal(key, shape), INDICES),
        "gumbel": _floats(jax.random.gumbel(key, shape), INDICES),
    }


def gammas() -> dict:
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 264)
    shape = (GAMMA_N,)
    return {
        "key": _key(key), "n": GAMMA_N, "indices": GAMMA_INDICES,
        "gamma_0.3": _floats(jax.random.gamma(key, 0.3, shape),
                             GAMMA_INDICES),
        "gamma_3.5": _floats(jax.random.gamma(key, 3.5, shape),
                             GAMMA_INDICES),
        "beta_2_6": _floats(jax.random.beta(key, 2.0, 6.0, shape),
                            GAMMA_INDICES),
    }


def slice_samples() -> dict:
    model = Initializer([MODEL_PATH], Settings().ccf_analysis(True)).model
    tree = compile_fault_tree(model.fault_trees.get("slice"))
    tape = ExpressionTape.build([e.expression for e in tree.basic_events])
    samples = np.asarray(tape.sample(jax.random.PRNGKey(SEED), SLICE_TRIALS,
                                     Settings().mission_time()))
    pairs = [[t, c, float(samples[t, c])] for t, c in SLICE_PAIRS]
    return {"key": _key(jax.random.PRNGKey(SEED)),
            "n_trials": SLICE_TRIALS, "n_outputs": int(samples.shape[1]),
            "pairs": pairs}


def cli_uncertainty() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        assert jax_cli([MODEL_PATH, *UNC_FLAGS, "-o", out]) == 0
        with open(out) as fh:
            report = json.load(fh)
    (ft,) = report["fault_trees"]
    return {"flags": UNC_FLAGS, "block": ft["uncertainty"]}


def test_settings(batch: int | None) -> Settings:
    """The settings of ``tests/test_torch_analysis.py``'s slice case."""
    settings = (Settings().algorithm("bdd").probability_analysis(True)
                .ccf_analysis(True).importance_analysis(False)
                .uncertainty_analysis(True).num_trials(TEST_TRIALS).seed(SEED))
    return settings.batch_size(batch) if batch else settings


def analysis_uncertainty() -> dict:
    blocks = {}
    for label, batch in (("unbatched", None), (f"batch_{TEST_BATCH}",
                                                 TEST_BATCH)):
        settings = test_settings(batch)
        model = Initializer([MODEL_PATH], settings).model
        (ft,) = RiskAnalysis(model, settings).run().fault_trees
        blocks[label] = ft.uncertainty
    return {"n_trials": TEST_TRIALS, "seed": SEED, "blocks": blocks}


STAGES = (("draws", draws), ("gamma", gammas),
          ("slice_samples", slice_samples),
          ("slice_uncertainty_4096", analysis_uncertainty),
          ("slice_uncertainty", cli_uncertainty))


def main() -> None:
    """Each stage is written as soon as it is done; ``--resume`` keeps the
    stages the file already holds."""
    golden = {}
    if "--resume" in sys.argv[1:] and os.path.exists(GOLDEN_PATH):
        with open(GOLDEN_PATH) as fh:
            golden = json.load(fh)
    golden.update({
        "derivation": "canopy_tpu (jax.random threefry2x32, partitionable, "
                      "float64) on the CPU; tools/make_torch_prng_golden.py",
        "jax_version": jax.__version__,
        "seed": SEED})
    for name, fn in STAGES:
        if name in golden:
            continue
        t0 = time.perf_counter()
        golden[name] = fn()
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
        with open(GOLDEN_PATH, "w") as fh:
            json.dump(golden, fh, indent=1, sort_keys=True)
    print(f"wrote {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
