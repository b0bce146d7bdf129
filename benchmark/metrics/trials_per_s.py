"""trials_per_s: the trials of every completed request over the whole
window (its start to the end of the last request)."""


def read(run):
    if run.mix["kind"] != "uncertainty":
        return None
    trials = sum(r["n_trials"] for r in run.records if not r.get("failed"))
    return trials / run.window_s
