"""Wall time of the torch port's RELAX NG validation (``io/xml.Validator``).

    python tools/relaxng_time.py [--reps N]

For each bundled grammar: the time to load it (parse and build every
pattern).  For every MEF fixture of ``tests/fixtures``: the time to parse
it and the time to validate the parsed tree against the bundled MEF
grammar, the best of ``--reps`` runs on a fresh ``Validator`` each (so no
derivative is reused across runs).  Prints one JSON object.  Host-only:
it needs neither a card nor JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    from canopy_tpu_torch.io.xml import Document, Validator
    from canopy_tpu_torch.schemas import (default_schema_path,
                                          project_schema_path,
                                          report_schema_path)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    def best(fn, setup=lambda: None):
        """The shortest of ``--reps`` timed calls ``fn(setup())``."""
        times = []
        for _ in range(args.reps):
            arg = setup()
            t0 = time.perf_counter()
            fn(arg)
            times.append(time.perf_counter() - t0)
        return min(times)

    out = {"host": platform.processor() or platform.machine(),
           "python": platform.python_version(), "reps": args.reps,
           "load_s": {}, "fixtures": {}}
    for name, path in (("mef", default_schema_path()),
                       ("report", report_schema_path()),
                       ("project", project_schema_path())):
        out["load_s"][name] = best(lambda _: Validator(path))
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                              "*.xml"))):
        document = Document(path)
        out["fixtures"][os.path.basename(path)] = {
            "bytes": os.path.getsize(path),
            "parse_s": best(lambda _: Document(path)),
            "validate_s": best(lambda v: v.validate(document),
                               lambda: Validator(default_schema_path()))}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
