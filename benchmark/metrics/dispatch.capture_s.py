"""Capturing the cell's frame graph: the run's ``dispatch.capture`` time
(the eager warm-up frames and the capture) less its ``kernels.build``
children, the share of set-up that only the program can shorten."""

from benchmark.metrics._spans import capture_s


def read(run):
    return capture_s()
