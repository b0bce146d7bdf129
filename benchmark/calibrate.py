"""Readings for the limits of ``correct`` (see ``canopy_bench/calibrate``).

    python3 benchmark/calibrate.py --workload <name> [--seeds 12]
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from canopy_bench.calibrate import main
    sys.exit(main())
