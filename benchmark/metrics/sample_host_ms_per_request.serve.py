"""sample_host_ms_per_request.serve: mean milliseconds a request's
sampling keeps the host busy and the device idle
(``canopy.uncertainty.sample`` spans, one a batch, each less the device's
busy time inside it, summed within each request span; the profiler's
trace)."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    groups = trace.within("bench.request", "canopy.uncertainty.sample")
    if not any(groups):
        return None
    return 1e3 * sum(trace.host_s(s, e) for g in groups for _n, s, e in g) \
        / len(groups)
