"""seq_transfers_per_request.serve_seq: the program's copies between host
and device (its ``h2d`` and ``d2h`` counters across the window) over the
window's completed event-tree requests."""


def read(run):
    counters = run.counters
    done = sum(1 for r in run.records if not r.get("failed"))
    if counters is None or not done:
        return None
    return (counters["h2d"] + counters["d2h"]) / done
