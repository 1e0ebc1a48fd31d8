"""The server's queue a message (``server.queue``: from ``publish()`` until
the worker takes it, its wake-up included), the median over the replay's
messages."""

from benchmark.metrics._spans import summed_ms


def read(run):
    return summed_ms(["server.queue"])
