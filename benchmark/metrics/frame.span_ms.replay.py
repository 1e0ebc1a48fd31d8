"""The device time of one graph replay (``frame.span``: two timing events
around it on the stream), the median over the replay's replays. Against
``frame.device_ms`` (the union of kernel intervals) it gives the gaps
between the graph's nodes. Nothing to read on the CPU."""

from benchmark.metrics._spans import median_ms


def read(run):
    return median_ms("frame.span")
