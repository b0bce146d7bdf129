"""stream_roofline.serve: the BDD stream kernel's share of its
roofline: the least time the card could take for the window's requests
(``roofline.stream_bound_s`` on the configuration's frozen work) over the
kernel time the profiler measured."""

KERNELS = ("stream_steps_kernel", "stream_ops_kernel",
           "stream_level_forward_kernel")


def read(run):
    trace = run.trace
    if trace is None:
        return None
    kernel_s = trace.kernel_s(*KERNELS)
    if kernel_s <= 0:
        return None
    work = run.config["work"]
    bound = sum(run.roofline.stream_bound_s(work, r["n_trials"])
                for r in run.records if not r.get("failed"))
    return 100.0 * bound / kernel_s
