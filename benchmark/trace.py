"""The traced slice of a run: ``torch.profiler`` over a few calls inside the
window, reduced to what the per-layer metrics and the run's ``device``
record read.

The event handling copies the port's ``utils/roofline.py`` (events from a
finished profile, the host calls that put work on a stream); the busy time
is the union of the device's kernel, copy and set intervals, so work on
two streams at once counts once.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

# CUDA API calls (the runtime's, and cuLaunchKernel) that put work on a
# stream: a captured frame's launches from the host are these, the kernels
# inside its graph are not
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
# the benchmark's own spans around its calls into the program
SPAN_PREFIX = "bench."
TOP = 10


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float
    on_device: bool


@dataclasses.dataclass
class TraceRecord:
    scans: int                    # scans whose work the slice holds
    window_s: float               # the slice's length on the host clock
    busy_s: float                 # union of device intervals
    host_launch_calls: int
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    breakdown: dict


class Tracer:
    """Start and stop ``torch.profiler`` around a slice of the window."""

    def __init__(self) -> None:
        self._prof = None
        self.record = None

    def warm(self) -> None:
        """Start and stop the profiler once on a small copy (set-up), so
        that its first start in the window costs what the others would."""
        import torch

        self.start()
        x = torch.ones(1024, device="cuda" if torch.cuda.is_available() else "cpu")
        (x + x).sum().item()
        self._prof.stop()
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._t0 = _now()

    def stop(self, scans: int) -> None:
        """End the slice (the caller's results are on the host, so the
        device is done with its work) and reduce it."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = _now() - self._t0
        self._prof.stop()
        self.record = reduce(events_from_profiler(self._prof), scans, wall)
        self._prof = None


def _now() -> float:
    import time

    return time.perf_counter()


def events_from_profiler(prof) -> List[Event]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        start = float(e.time_range.start)
        out.append(Event(e.name, start, start + float(e.time_range.elapsed_us()),
                         e.device_type == DeviceType.CUDA))
    return out


def _is_work(e: Event) -> bool:
    """A kernel, copy or set on the device (not a range's device span)."""
    return e.on_device and not e.name.startswith(SPAN_PREFIX)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_at(t_us: float, host: List[Event]) -> str:
    """What the host was doing at ``t_us``: the innermost of the
    benchmark's spans and the innermost other host event that cover it."""
    span, op = None, None
    for e in host:
        if e.start_us <= t_us < e.end_us:
            if e.name.startswith(SPAN_PREFIX):
                if span is None or e.end_us - e.start_us < span.end_us - span.start_us:
                    span = e
            elif op is None or e.end_us - e.start_us < op.end_us - op.start_us:
                op = e
    names = [e.name for e in (span, op) if e is not None]
    return " / ".join(names) if names else "no_host_event"


def reduce(events: List[Event], scans: int, wall_s: float) -> TraceRecord:
    work = [e for e in events if _is_work(e)]
    host = [e for e in events if not e.on_device]
    busy = _union([(e.start_us, e.end_us) for e in work])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in work:
        k = kernels[e.name]
        k[0] += 1
        k[1] += (e.end_us - e.start_us) * 1e-6
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return TraceRecord(
        scans=scans,
        window_s=wall_s,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        host_launch_calls=sum(e.name.startswith(HOST_LAUNCH_CALLS) for e in host),
        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
        breakdown={
            "device_ops": [[name, v[1]] for name, v in top_ops],
            "idle_gaps": [[_host_at(0.5 * (a + b), host), (b - a) * 1e-6]
                          for a, b in gaps[:TOP]],
        },
    )
