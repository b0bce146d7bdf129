"""stats_ms_per_request.serve: mean milliseconds a request spends in the
program's statistics (``canopy.uncertainty.statistics`` spans, summed
within each request span; the profiler's trace)."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    groups = trace.within("bench.request", "canopy.uncertainty.statistics")
    if not any(groups):
        return None
    return 1e3 * sum((e - s) / 1e6 for g in groups for _n, s, e in g) / \
        len(groups)
