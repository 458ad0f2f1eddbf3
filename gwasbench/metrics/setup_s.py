"""setup_s: seconds from the process's start to the window's, the kernels'
build or load, the inputs made from the seed and the warm-up calls with
them (host clock)."""


def read(run):
    return run.setup_s
