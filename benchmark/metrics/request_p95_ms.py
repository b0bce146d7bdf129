"""request_p95_ms: the 95th percentile of every request's latency in the
window, from its arrival (in a closed loop, the moment its client sends
it) to the return of its host result, whatever the request's kind."""

import numpy as np


def read(run):
    latencies = [(r["end"] - r["arrival"]) * 1e3 for r in run.records]
    return float(np.quantile(latencies, 0.95))
