"""Device time a scan in the traced slice of a replay cell: the union of
the kernels', copies' and sets' intervals, over the slice's scans."""


def read(run):
    t = run.trace
    if t is None or not t.scans or t.busy_s <= 0:
        return None
    return t.busy_s / t.scans * 1e3
