"""The host's time issuing a step's replays a scan (``dispatch.launch``:
the copy-in, the ``npts`` write, the graph replays and the result copies),
the median over the drive's steps."""

from benchmark.metrics._spans import summed_ms


def read(run):
    return summed_ms(["dispatch.launch"])
