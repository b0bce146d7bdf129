"""evaluate_host_ms_per_request.serve: mean milliseconds of a request's
evaluation in which the device ran nothing (``canopy.uncertainty.
evaluate`` spans, each less the device's busy time inside it, summed
within each request span; the profiler's trace)."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    groups = trace.within("bench.request", "canopy.uncertainty.evaluate")
    if not any(groups):
        return None
    return 1e3 * sum(trace.host_s(s, e) for g in groups for _n, s, e in g) \
        / len(groups)
