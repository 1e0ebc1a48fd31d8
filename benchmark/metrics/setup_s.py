"""Process start to the window's start on the host clock: making the
drive, loading (or, in a checkout's first run, building) the kernels,
capturing the cell's graph and the warm-up."""


def read(run):
    return run.setup_s
