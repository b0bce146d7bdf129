"""Shared helpers of the torch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on its CPU backend (its Pallas kernels in interpret
mode), the port on the CPU through its kernels' plain versions.
"""

import collections
import math
import os

import numpy as np
import pytest
import torch

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

#: Fixtures whose fault trees quantify through the exact-BDD path.
FAULT_TREE_FIXTURES = [
    "aralia_like_small", "aralia_like_medium", "aralia_like_large",
    "aralia_like_ccf", "aralia_like_noncoherent",
    "aralia_like_nested_count", "aralia_like_substitution",
    "brute_noncoherent"]
ALL_FIXTURES = sorted(f[:-4] for f in os.listdir(FIXTURES)
                      if f.endswith(".xml"))


#: Fixtures that hold only what they add to another: loaded after it.
FIXTURE_BASES = {"torch_event_tree_plant": ["torch_slice_plant"]}


def fixture_path(name: str) -> str:
    return os.path.join(FIXTURES, f"{name}.xml")


def fixture_inputs(name: str) -> list[str]:
    """The MEF files of fixture ``name``: those it builds on, then its
    own."""
    return [fixture_path(n) for n in FIXTURE_BASES.get(name, []) + [name]]


def load_tree(pkg: str, name: str, ccf: bool = True,
              tree_name: str | None = None):
    """(model, compiled tree) of fixture ``name``'s fault tree
    ``tree_name`` (default: the fixture's name) from either package
    (``"canopy_tpu"`` or ``"canopy_tpu_torch"``)."""
    import importlib
    mef = importlib.import_module(f"{pkg}.mef")
    settings_mod = importlib.import_module(f"{pkg}.settings")
    graph = importlib.import_module(f"{pkg}.compiler.graph")
    settings = settings_mod.Settings().ccf_analysis(ccf)
    model = mef.Initializer(fixture_inputs(name), settings).model
    fault_tree = model.fault_trees.get(tree_name or name)
    return model, graph.compile_fault_tree(fault_tree)


def run_both_analyses(path: str, configure=lambda settings: settings):
    """(port report, JAX report) of the MEF file ``path``: ``RiskAnalysis``
    of each package on the CPU, its ``Settings`` passed through
    ``configure``."""
    from canopy_tpu.engine.analysis import RiskAnalysis as JaxAnalysis
    from canopy_tpu.mef import Initializer as JaxInitializer
    from canopy_tpu.settings import Settings as JaxSettings
    from canopy_tpu_torch.engine.analysis import RiskAnalysis
    from canopy_tpu_torch.mef import Initializer
    from canopy_tpu_torch.settings import Settings
    settings = configure(Settings())
    ours = RiskAnalysis(Initializer([path], settings).model, settings,
                        "cpu").run()
    jax_settings = configure(JaxSettings())
    ref = JaxAnalysis(JaxInitializer([path], jax_settings).model,
                      jax_settings).run()
    return ours, ref


def launches_since(before: dict) -> collections.Counter:
    """The kernels launched since the ``counters()`` snapshot ``before``,
    by kernel name (a kernel that did not launch reads 0 and compares as
    absent)."""
    from canopy_tpu_torch.utils.profiling import counters
    after = counters()
    return collections.Counter({
        key[len("launch."):]: after[key] - before[key] for key in after
        if key.startswith("launch.") and after[key] != before[key]})


def rel_err(got: float, want: float) -> float:
    """``|got - want| / |want|``, 0 where the two are equal."""
    if got == want:
        return 0.0
    return abs(got - want) / max(abs(want), 1e-300)


def assert_sequence_stats(got: dict, row: np.ndarray) -> None:
    """``got``, a sequence's statistics, against NumPy's calls on its
    trials ``row``: the 95 % interval and the error factor to the bit,
    mean and ``std(ddof=1)`` within 1e-13 relative."""
    assert got["n_trials"] == len(row)
    lo, hi = np.quantile(row, [0.025, 0.975])
    assert got["ci95"] == [float(lo), float(hi)]
    median = float(np.median(row))
    p95 = float(np.quantile(row, 0.95))
    want_ef = p95 / median if median > 0 else math.inf
    assert got["error_factor"] == want_ef
    std = float(np.std(row, ddof=1)) if len(row) > 1 else 0.0
    for key, want in (("mean", float(np.mean(row))), ("std", std)):
        assert rel_err(got[key], want) <= 1e-13, (key, got[key], want)


def overwriting_program(stream_program_cls):
    """A hand-written stream program whose ops write the very pool slot
    one of their own arguments reads (the linear-scan allocator allows
    it), with a spill, a count gate, a pair, an inverted product, a fill
    and a mux.  ``stream_program_cls`` is either package's
    ``StreamProgram``."""
    stage = lambda off: ("stage", 0, off)  # noqa: E731
    ops = [
        ("start", 0, 0), ("wait", 0, 0),
        ("spill", 0, 5, 3),
        ("gate", "prod", 0, [(stage(0), False), (stage(1), True)], False),
        ("gate", "count", 1, [(("pool", 0), False), (stage(2), False),
                              (stage(3), True), (("pool", 3), False)],
         (2, 3)),
        # out slot 0 == argument slot 0:
        ("gate", "pair", 0, [(("pool", 0), False), (("pool", 1), True)],
         False),
        # out slot 1 == argument slot 1, inverted product:
        ("gate", "prod", 1, [(("pool", 1), False), (("pool", 0), True),
                             (stage(4), False)], True),
        ("gate", "fill", 2, [], 0.25),
        # out slot 0 == its lo argument:
        ("gate", "mux", 0, [(("pool", 3), False), (("pool", 1), False),
                            (("pool", 0), False)], None),
    ]
    return stream_program_cls(
        ops=ops, basic_perm=np.arange(6), n_basic=6, n_basic_pad=8,
        chunk_tiles=8, n_chunks=1, n_bufs=1, pool_slots=4, top_slot=0,
        nnz=15, n_house=0)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: kernel cases run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested here)")
    return torch.device("cuda")


def walk_ring(enc, ring, staged: torch.Tensor, house: torch.Tensor,
              with_log: bool = False):
    """The ring kernel's walk of its op stream (``csrc/replay_ops.cuh``),
    in plain torch: chunk by chunk, each header and argument word decoded
    as the kernel decodes it, every ring read taken from the slot its
    entry was issued into (``depth - 1`` consumptions earlier, the fetch
    read at issue time, so an eviction-log row fetched before its EVICT
    raises ``KeyError``, and one fetched after a later EVICT of the same
    row reads the later value).  ``enc`` is a replay program (its
    resident tier the staged prefix), a spill program (its scratch rows
    the eviction log) or a fused live-row program.  Returns ``(top, value
    log or None)``."""
    from canopy_tpu_torch.ops import stream_kernel as tsk
    D, T = ring.depth, staged.shape[1]
    P, R = enc.pool_slots, getattr(enc, "res_rows", 0)
    shared: list = [None] * P + [staged[i] for i in range(R)]
    evlog: dict = {}
    vlog: list = [None] * enc.n_log
    slots: list = [None] * D
    state = {"k": 0}

    def fetch(code):
        if code == 0:
            return None
        if code < tsk._RING_EVLOG:
            return staged[code - 1]
        return evlog[code - tsk._RING_EVLOG]

    def issue(code):
        """Consume entry k: issue entry k + D - 1 into the slot of k - 1."""
        entry = state["k"] + D - 1
        slots[entry % D] = (entry, fetch(code))
        state["k"] += 1

    def take(code):
        entry, value = slots[state["k"] % D]
        assert entry == state["k"] and value is not None
        issue(code)
        return value

    for e in range(D - 1):
        slots[e] = (e, fetch(int(ring.head[e])))
    words = ring.words.tolist()
    cw_len = ring.chunk_words
    for c in range(ring.n_chunks):
        cw = words[c * cw_len:(c + 1) * cw_len]
        w = 0
        while w < cw_len and cw[w] >= 0:
            kind, slot, b, e, aux0, _aux1, row, extra = cw[w:w + 8]
            if kind == tsk.EVICT:
                evlog[aux0] = shared[slot]
                for j in range(b, e):
                    issue(cw[j] & tsk._PAYLOAD)
            elif kind == tsk.REFILL:
                shared[slot] = take(extra)
            else:
                k0 = state["k"]

                def load(word):
                    payload = word & tsk._PAYLOAD
                    src = (word & 0xFFFFFFFF) >> 30
                    v = shared[payload] if src == tsk._W_SHARED else \
                        take(payload) if src == tsk._W_RING else \
                        house[payload].expand(T)
                    return 1.0 - v if (word >> 29) & 1 else v
                v = tsk._plain_value(cw[w:w + 7], 0.0, cw, load, staged)
                # A count DP that reads nothing (cap 0) passes its ring
                # reads on as pads.
                ring_words = [x for x in cw[b:e]
                              if (x & 0xFFFFFFFF) >> 30 == tsk._W_RING]
                for x in ring_words[state["k"] - k0:extra]:
                    issue(x & tsk._PAYLOAD)
                shared[slot] = v
                if with_log:
                    vlog[row] = v
            w = e
    return shared[enc.top_slot], (torch.stack(vlog) if with_log else None)
