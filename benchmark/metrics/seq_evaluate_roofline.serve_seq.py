"""seq_evaluate_roofline.serve_seq: the sequences' evaluation's share of
its roofline: the least time for the window's requests
(``sequence_roofline.evaluate_bound_s`` on the configuration's frozen
work) over the device's busy time inside the ``canopy.event_tree.
evaluate`` spans (the profiler's trace)."""

from canopy_bench.sequence_roofline import evaluate_bound_s


def read(run):
    trace = run.trace
    if trace is None:
        return None
    groups = trace.within("bench.request", "canopy.event_tree.evaluate")
    busy_s = sum(trace.busy_s(s, e) for g in groups for _n, s, e in g)
    if busy_s <= 0:
        return None
    work = run.config["work"]
    bound = sum(evaluate_bound_s(work, r["n_trials"])
                for r in run.records if not r.get("failed"))
    return 100.0 * bound / busy_s
