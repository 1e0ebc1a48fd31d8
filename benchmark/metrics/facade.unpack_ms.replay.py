"""The host's unpacking a scan (``facade.unpack``: the bits, the fields,
the ground and non-ground index arrays, the processed patches), the median
over the replay's steps."""

from benchmark.metrics._spans import summed_ms


def read(run):
    return summed_ms(["facade.unpack"])
