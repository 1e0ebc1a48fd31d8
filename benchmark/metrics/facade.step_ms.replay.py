"""The facade's time a scan, the median over the window's scans of
``SegmentationResult.time_taken_s``: upload, graph replay, readback and
unpack."""

import numpy as np


def read(run):
    if not run.step_s:
        return None
    return float(np.median(run.step_s)) * 1e3
