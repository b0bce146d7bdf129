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
  the stated one stands in the program's place).

A new kind is a new file; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["load_kind", "make_cell"]


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
