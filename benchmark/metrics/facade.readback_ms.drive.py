"""The packed result's copy back a scan (``facade.readback``: the host
waiting for the device, then the device -> host copy), the median over the
drive's steps."""

from benchmark.metrics._spans import summed_ms


def read(run):
    return summed_ms(["facade.readback"])
