"""trials_per_s: the trials (``n_trials``) of every completed request over
the whole window (its start to the end of the last request); nothing
where no record counts trials."""


def read(run):
    if not any("n_trials" in r for r in run.records):
        return None
    trials = sum(r.get("n_trials", 0) for r in run.records
                 if not r.get("failed"))
    return trials / run.window_s
