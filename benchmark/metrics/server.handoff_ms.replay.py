"""The server's share of a scan: the median, over the window's scans, of
publish to callback less the facade's own time for that scan
(``SegmentationResult.time_taken_s``): the queue, the worker's wake-up and
the callback's dispatch."""

import numpy as np


def read(run):
    if not run.handoff_s:
        return None
    return float(np.median(run.handoff_s)) * 1e3
