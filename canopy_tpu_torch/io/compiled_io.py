"""Compiled-model serialization: parse/compile once, serve many times.

The JAX package's ``.npz`` interchange (``canopy_tpu/io/compiled_io.py``),
format version 1, byte for byte: one archive holds the level-scheduled
:class:`~canopy_tpu_torch.compiler.graph.CompiledTree` blocks plus
(optionally) the SSA expression tape, so a serving process skips XML
parsing, validation, model building, CCF expansion, and level
scheduling and goes straight to the engines.  A file written by either
package loads in the other: the block arrays are numpy, and the tape's
op list is the same in both (only its evaluators differ).

Everything engines touch round-trips: block arrays, slot maps (by id),
the top index, tape ops.  The MEF *object* graph deliberately does not
(it is the authoring form; re-serialize with ``io/mef_writer`` for
that), so loaded trees have empty ``basic_events``/``gates`` object
lists — engines only use arrays and index maps.
"""

from __future__ import annotations

import json

import numpy as np

from ..compiler.expr_tape import ExpressionTape
from ..compiler.graph import (CompiledTree, CountBlock, LevelBlock,
                              PairBlock, ProdBlock)
from ..errors import LogicError

__all__ = ["save_compiled", "load_compiled"]

_FORMAT_VERSION = 1

_BLOCK_FIELDS = {
    "prod": ("out_idx", "arg_idx", "arg_flip", "arg_mask", "inv_out"),
    "pair": ("out_idx", "arg_idx", "arg_neg", "is_iff"),
    "count": ("out_idx", "arg_idx", "arg_neg", "arg_mask", "min_num",
              "max_num"),
}
_BLOCK_TYPES = {"prod": ProdBlock, "pair": PairBlock, "count": CountBlock}


def save_compiled(path, tree: CompiledTree,
                  tape: ExpressionTape | None = None) -> None:
    """Write ``tree`` (and optionally its expression ``tape``) to
    ``path`` as one .npz archive."""
    arrays: dict[str, np.ndarray] = {}
    level_meta = []
    for li, level in enumerate(tree.levels):
        blocks_meta = []
        for bi, (kind, block) in enumerate(level.iter_blocks()):
            prefix = f"L{li}B{bi}_"
            for field in _BLOCK_FIELDS[kind]:
                arrays[prefix + field] = np.asarray(getattr(block, field))
            entry = {"kind": kind, "prefix": prefix}
            if kind == "count":
                entry["cap"] = int(block.cap)
            blocks_meta.append(entry)
        level_meta.append(blocks_meta)

    meta = {
        "format": _FORMAT_VERSION,
        "n_basic": tree.n_basic,
        "n_house": tree.n_house,
        "n_gates": tree.n_gates,
        "top_index": tree.top_index,
        "basic_index": tree.basic_index,
        "house_index": tree.house_index,
        "gate_index": tree.gate_index,
        "levels": level_meta,
        "house_states": [bool(h.state) for h in tree.house_events]
        if tree.house_events else None,
    }
    if tape is not None:
        meta["tape"] = {
            "ops": [[kind, slot, list(arg_slots), aux]
                    for kind, slot, arg_slots, aux in tape._ops],
            "n_slots": tape._n_slots,
            "out_slots": list(tape._out_slots),
            "n_deviates": tape.n_deviates,
        }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_compiled(path) -> tuple[CompiledTree, ExpressionTape | None]:
    """Load a compiled model saved by :func:`save_compiled`."""
    with np.load(path) as archive:
        meta = json.loads(bytes(archive["__meta__"]).decode("utf-8"))
        if meta.get("format") != _FORMAT_VERSION:
            raise LogicError(
                f"unsupported compiled-model format: {meta.get('format')}")
        levels = []
        for blocks_meta in meta["levels"]:
            prods, pairs, counts = [], [], []
            for entry in blocks_meta:
                kind, prefix = entry["kind"], entry["prefix"]
                fields = {f: archive[prefix + f]
                          for f in _BLOCK_FIELDS[kind]}
                if kind == "count":
                    fields["cap"] = entry["cap"]
                block = _BLOCK_TYPES[kind](**fields)
                {"prod": prods, "pair": pairs,
                 "count": counts}[kind].append(block)
            levels.append(LevelBlock(prods=prods, pairs=pairs,
                                     counts=counts))

    # House events are semantic state (flipped by event-tree walks /
    # alignment phases), so they are reconstructed as real objects;
    # basic events and gates stay array-only (the tape carries their
    # probability semantics).
    house_events = []
    if meta["n_house"]:
        from ..mef.event import HouseEvent

        names = sorted(meta["house_index"],
                       key=lambda k: meta["house_index"][k])
        states = meta["house_states"] or [False] * len(names)
        house_events = [HouseEvent(name, state=bool(state))
                        for name, state in zip(names, states)]

    tree = CompiledTree(
        n_basic=meta["n_basic"], n_house=meta["n_house"],
        n_gates=meta["n_gates"],
        basic_index={k: int(v) for k, v in meta["basic_index"].items()},
        house_index={k: int(v) for k, v in meta["house_index"].items()},
        gate_index={k: int(v) for k, v in meta["gate_index"].items()},
        levels=levels, basic_events=[], house_events=house_events,
        gates=[], top_index=meta["top_index"])

    tape = None
    if "tape" in meta:
        tape = ExpressionTape()
        tape._ops = [(kind, slot, list(arg_slots), _aux(aux))
                     for kind, slot, arg_slots, aux in meta["tape"]["ops"]]
        tape._n_slots = meta["tape"]["n_slots"]
        tape._out_slots = list(meta["tape"]["out_slots"])
        tape.n_deviates = meta["tape"]["n_deviates"]
    return tree, tape


def _aux(aux):
    # JSON round-trips tuples as lists; tape aux values are scalars or
    # tuples of scalars.
    return tuple(aux) if isinstance(aux, list) else aux
