"""Request kinds, found by name: a mix's ``kind`` names the file
``kinds/<kind>.py`` beside the harness.  A kind module holds

* ``MIX_KEYS``: the mix keys it reads beyond the generator's own;
* ``round_shapes(mix)``: the requests of one round, without seeds;
* ``work(request)``: a request's size (the check's sample holds the
  largest);
* ``label(request)``: the name of the request's span;
* ``Cell(config, mix, device, paths)``: ``setup()``, ``run(request)``
  (the timed path; returns the request's record), ``free()``, and
  ``judge(records, reference, control=False)`` (the worst gaps that
  decide ``correct``; with ``control`` the reference one precision below
  the stated one stands in the program's place);
* optionally ``reference(paths, device)``: the reference its ``judge``
  reads.  Without it the check builds ``reference.Reference(paths,
  device)``, which reads fault trees of lognormal events and nothing else.
  A kind's own reference lives in new files under
  ``canopy_bench/reference/`` and keeps that package's rules: it imports
  nothing of the program under test and nothing of JAX, and takes nothing
  the program made; it works its answers out again from the model files
  and the seed.

A record is what ``Cell.run`` returns for a request, the request's keys
among them.  The harness adds ``arrival``, ``start`` and ``end``
(seconds into the window; the latency runs from arrival to end), and a
request that raised is recorded as itself with ``failed`` true.  A kind
whose requests are trials gives each record ``n_trials``: the trial rate
sums it over the records that did not fail.

A new kind is new files; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["load_kind", "make_cell", "make_reference"]


def load_kind(bench: str, name: str):
    module_name = "bench_kind_" + name.replace(".", "_").replace("-", "_")
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            module_name, os.path.join(bench, "kinds", name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[module_name] = module
    return sys.modules[module_name]


def make_cell(config: dict, mix: dict, device, root: str, kind):
    return kind.Cell(config, mix, device,
                     [os.path.join(root, p) for p in config["mef"]])


def make_reference(kind, paths: list, device):
    """The kind's own reference where its module defines one, else the
    fault-tree reference."""
    if hasattr(kind, "reference"):
        return kind.reference(paths, device)
    from .reference import Reference
    return Reference(paths, device)
