"""The facade's upload a scan: ``facade.stage`` (the zeroed NumPy stack and
the scans copied into it) plus ``facade.upload`` (the host -> device copy
and the zero-extension), summed a step, the median over the replay's steps."""

from benchmark.metrics._spans import summed_ms


def read(run):
    return summed_ms(["facade.stage", "facade.upload"])
