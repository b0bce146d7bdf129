"""host_ms_per_request.serve: mean milliseconds of a request in which the
device ran nothing: each request span less the device's busy time inside
it (the profiler's trace)."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = trace.named("bench.request")
    if not spans:
        return None
    host = [trace.host_s(s, e) for _n, s, e in spans]
    return 1e3 * sum(host) / len(host)
