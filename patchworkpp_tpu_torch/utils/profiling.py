"""Profiling / tracing utilities (port of ``patchworkpp_tpu/utils/profiling.py``).

The reference instruments its frame with hand-rolled clock() segment timers
printed under ``verbose`` (reference: cpp/patchworkpp/src/patchworkpp.cpp:179,
:323-333). Here: a host-side accumulating segment timer (the serving loop's
wait/infer split) and a ``torch.profiler`` trace of a block, written as a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class FrameTimer:
    """Accumulating named segment timer (getTimeTaken() analog)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.frames = 0

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0

    def tick_frame(self) -> None:
        self.frames += 1

    @property
    def time_taken_us(self) -> float:
        """Total accumulated microseconds (reference getTimeTaken unit)."""
        return sum(self.totals.values()) * 1e6

    def report(self) -> str:
        per_frame = max(self.frames, 1)
        parts = [
            f"{k}: {v / per_frame * 1000:.2f}ms" for k, v in sorted(self.totals.items())
        ]
        return f"frames={self.frames}  " + "  ".join(parts)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Trace a block with ``torch.profiler`` (the host, and the card when
    CUDA is available) and write ``<logdir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). No-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
