"""Scans whose results reached the host in the window, over the window's
seconds on the host clock (the sequence cells)."""


def read(run):
    if run.window_s <= 0 or not run.scans:
        return None
    return run.scans / run.window_s
