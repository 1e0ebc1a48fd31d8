"""The 95th percentile, over every scan of the window but the profiled
slice, of publish to callback on the host clock (the replay cells). A
per-layer metric: over a 51 s window its spread between runs of one tree
(~12-15% on the H100's host) is too wide to gate a change by."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
