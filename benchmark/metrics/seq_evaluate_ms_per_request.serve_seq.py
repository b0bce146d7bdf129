"""seq_evaluate_ms_per_request.serve_seq: mean milliseconds a request
spends evaluating its sequences (``canopy.event_tree.evaluate`` spans'
length, summed within each request span; the profiler's trace)."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    groups = trace.within("bench.request", "canopy.event_tree.evaluate")
    if not any(groups):
        return None
    return 1e3 * sum((e - s) / 1e6 for g in groups for _n, s, e in g) / \
        len(groups)
