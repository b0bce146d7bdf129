"""sampler_roofline.serve: ``draw_standard``'s share of its roofline:
the least time for the window's draws (``roofline.sampler_bound_s``:
threefry's integer operations on the ALU lanes against the float64 table
written) over the kernel time the profiler measured."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    kernel_s = trace.kernel_s("draw_standard_kernel")
    if kernel_s <= 0:
        return None
    work = run.config["work"]
    bound = sum(run.roofline.sampler_bound_s(work, r["n_trials"])
                for r in run.records if not r.get("failed"))
    return 100.0 * bound / kernel_s
