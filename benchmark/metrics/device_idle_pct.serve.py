"""device_idle_pct.serve: the share of the traced window in which no
kernel, copy or fill ran on the device, in percent."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
