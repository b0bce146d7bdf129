"""setup_s: seconds from the process's start to the first timed request
or job: imports, the kernels' build or load, the model's set-up and the
warm-up of every shape the window sends."""


def read(run):
    return run.setup_s
