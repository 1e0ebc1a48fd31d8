"""The median, over every scan of the window, of publish to callback on the
host clock (the replay cells)."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 50)) * 1e3
