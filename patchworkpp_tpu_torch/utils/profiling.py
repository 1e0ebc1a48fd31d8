"""Profiling / tracing utilities (port of ``patchworkpp_tpu/utils/profiling.py``).

The reference instruments its frame with hand-rolled clock() segment timers
printed under ``verbose`` (reference: cpp/patchworkpp/src/patchworkpp.cpp:179,
:323-333). Here one in-memory span recorder does that for the whole port:
the facade, the dispatch layer, the kernel builder and the server record
named spans through it, and :class:`FrameTimer` (the serving loop's
wait/infer totals) records its segments as ``server.`` spans too.

A span record holds:

- ``name``; ``start_ns``, its start on ``time.time_ns()``, the clock of a
  ``torch.profiler`` trace's events (counted from the trace's
  ``kineto_results.trace_start_ns()``); ``dur_ns``, its duration on
  ``time.perf_counter_ns()``;
- ``parent``, the id of the enclosing span on the same thread (0: none),
  and its own ``id``;
- ``request``, an id shared by every span of one request: a facade step, or
  a server message (the server opens one at ``publish()``, see
  :func:`new_request` and :func:`request`);
- ``scans``, the number of scans its work covered;
- ``profiled``, whether a ``torch.profiler`` was running in the process
  while it was open (its time then carries the profiler's cost).

Memory is fixed: each span name keeps its last ``CAPACITY`` (32,768) records
in a ring of int64 rows (1.8 MB) made at its first record, with a running
count and sum, so nothing grows with uptime. Recording is safe from several threads at once. The recorder is on
by default (as the reference's ``time_taken_`` is); ``enable(False)`` turns
it off, and a span then costs one boolean check.

A span marked ``host_only`` (work that launches nothing on the device) also
opens a ``torch.profiler`` range of its name, when the profiler records the
span's thread, so that a trace names the host's work between device events.
A span that encloses device work never opens one: the range would get a
device-side span under its name, which a trace reader would take for a
kernel.

A step whose scans interleave their phases (the facade's pipeline:
scan i+1 staged while scan i runs on the card) times each phase with
:func:`phase`, entered once a scan, and records its sum as one span of the
step.

Read with :func:`spans` (the records of one name, oldest first),
:func:`counters` (count and total seconds of every span name and event
counter) and :func:`timing_report`.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 32768


class SpanRecord(NamedTuple):
    name: str
    start_ns: int      # time.time_ns() at the start (the profiler trace's clock)
    dur_ns: int        # perf_counter_ns() difference
    parent: int        # id of the enclosing span on its thread; 0 for none
    id: int
    request: int       # shared by every span of one facade step or server message
    scans: int         # scans its work covered
    profiled: bool     # a torch.profiler ran while it was open

    @property
    def seconds(self) -> float:
        return self.dur_ns * 1e-9


class Count(NamedTuple):
    n: int             # spans recorded (or events counted), ever
    seconds: float     # their total duration (0.0 for an event counter)


def _profiler_running() -> bool:
    """A ``torch.profiler`` (or autograd profiler) is running in this
    process, on whichever thread it was started."""
    return bool(_autograd_profiler._is_profiler_enabled)


class _Ring:
    """The last ``CAPACITY`` records of one span name (rows of
    ``SpanRecord``'s fields after the name, ``profiled`` as 0 or 1), and
    the running count and sum of all of them."""

    __slots__ = ("data", "n", "total_ns")

    def __init__(self) -> None:
        self.data = np.zeros((CAPACITY, len(SpanRecord._fields) - 1), np.int64)
        self.n = 0
        self.total_ns = 0


class _Span:
    """An open span: the context manager :meth:`Recorder.span` returns."""

    __slots__ = ("_rec", "name", "scans", "host_only", "id", "parent", "request",
                 "start_ns", "_t0", "dur_ns", "_profiled", "_range", "_stack")

    def __init__(self, rec: "Recorder", name: str, scans: int, host_only: bool) -> None:
        self._rec = rec
        self.name = name
        self.scans = scans
        self.host_only = host_only
        self.dur_ns = 0

    def __enter__(self) -> "_Span":
        rec = self._rec
        tls = rec._local()
        stack = tls.stack
        self.parent = stack[-1].id if stack else 0
        if tls.request:
            self.request = tls.request
        elif stack:
            self.request = stack[-1].request
        else:
            self.request = next(rec._request_ids)
        self.id = next(rec._span_ids)
        stack.append(self)
        self._stack = stack
        self._profiled = _profiler_running()
        self._range = None
        if self.host_only and self._profiled and torch._C._autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._stack.pop()
        self._rec._write(self.name, (self.start_ns, self.dur_ns, self.parent, self.id,
                                     self.request, self.scans,
                                     self._profiled or _profiler_running()))

    @property
    def seconds(self) -> float:
        return self.dur_ns * 1e-9


class _Stopwatch:
    """What a timed span is while the recorder is off: its duration only."""

    __slots__ = ("_t0", "dur_ns")

    def __enter__(self) -> "_Stopwatch":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns = time.perf_counter_ns() - self._t0

    @property
    def seconds(self) -> float:
        return self.dur_ns * 1e-9


class _Phase:
    """An open phase: the context manager :meth:`Recorder.phase` returns."""

    __slots__ = ("_rec", "name", "host_only", "start_ns", "dur_ns", "profiled", "_t0",
                 "_range")

    def __init__(self, rec: "Recorder", name: str, host_only: bool) -> None:
        self._rec = rec
        self.name = name
        self.host_only = host_only
        self.start_ns = None
        self.dur_ns = 0
        self.profiled = False
        self._range = None

    def __enter__(self) -> "_Phase":
        if _profiler_running():
            self.profiled = True
            if self.host_only and torch._C._autograd._profiler_enabled():
                self._range = torch.autograd.profiler.record_function(self.name)
                self._range.__enter__()
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns += time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def done(self, scans: int) -> None:
        """Record the summed time as one span covering ``scans`` scans."""
        if self.start_ns is not None:
            self._rec.record(self.name, self.start_ns, self.dur_ns, scans=scans,
                             profiled=self.profiled)


class _Off:
    """What an untimed span or a phase is while the recorder is off."""

    __slots__ = ()
    dur_ns = 0
    seconds = 0.0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def done(self, scans: int) -> None:
        return None


_OFF = _Off()


class Recorder:
    """Named spans and event counters in fixed memory (see the module's
    docstring)."""

    def __init__(self) -> None:
        self.enabled = True
        self._rings: Dict[str, _Ring] = {}
        self._events: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._span_ids = itertools.count(1)
        self._request_ids = itertools.count(1)

    def _local(self):
        tls = self._tls
        try:
            tls.stack
        except AttributeError:
            tls.stack = []
            tls.request = 0
        return tls

    def _write(self, name: str, row) -> None:
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = self._rings[name] = _Ring()
            ring.data[ring.n % CAPACITY] = row
            ring.n += 1
            ring.total_ns += row[1]

    # ------------------------------------------------------------ recording

    def span(self, name: str, scans: int = 1, host_only: bool = False, timed: bool = False):
        """A context manager that records one span of ``name`` covering
        ``scans`` scans. ``host_only``: its work launches nothing on the
        device, so it may open a profiler range (module docstring).
        ``timed``: its ``seconds`` are measured even with the recorder off
        (the facade's ``time_taken_s``)."""
        if not self.enabled:
            return _Stopwatch() if timed else _OFF
        return _Span(self, name, scans, host_only)

    def record(self, name: str, start_ns: int, dur_ns: int, request: Optional[int] = None,
               parent: Optional[int] = None, scans: int = 1, profiled: bool = False) -> None:
        """Record a span measured elsewhere (a wait that began on another
        thread, a device time read from CUDA events, a phase's time summed
        over a step's scans) covering ``scans`` scans. ``request`` and
        ``parent`` default to :meth:`current`'s (a new request where there
        is none); it is ``profiled`` if a profiler ran while it was measured
        or runs now."""
        if not self.enabled:
            return
        cur_request, cur_parent = self.current()
        if request is None:
            request = cur_request or next(self._request_ids)
        if parent is None:
            parent = cur_parent
        self._write(name, (int(start_ns), int(dur_ns), parent, next(self._span_ids), request,
                           scans, profiled or _profiler_running()))

    def phase(self, name: str, host_only: bool = False):
        """A context manager entered once a scan, whose host time adds up
        over a step's scans; its ``done(scans)`` records the sum as one span
        of ``name`` (so a step holds one record of each phase, however its
        scans interleave). ``host_only`` as in :meth:`span`: each entry
        may open a profiler range."""
        return _Phase(self, name, host_only) if self.enabled else _OFF

    def current(self):
        """(request, parent) for a span recorded later on this thread's
        behalf: the current request (0: none) and the innermost open span's
        id (0: none)."""
        tls = self._local()
        stack = tls.stack
        if stack:
            return tls.request or stack[-1].request, stack[-1].id
        return tls.request, 0

    def new_request(self) -> int:
        """A fresh request id (the server takes one for each message)."""
        return next(self._request_ids)

    @contextlib.contextmanager
    def request(self, request_id: int) -> Iterator[None]:
        """Spans opened on this thread inside the block belong to
        ``request_id``."""
        tls = self._local()
        outer = tls.request
        tls.request = request_id
        try:
            yield
        finally:
            tls.request = outer

    def count(self, name: str, n: int = 1) -> None:
        """Advance the event counter ``name`` (a kernel compiled, a graph
        captured)."""
        if self.enabled:
            with self._lock:
                self._events[name] += n

    # ------------------------------------------------------------ reading

    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """The kept records of ``name`` (of every name if None), oldest
        first."""
        with self._lock:
            copies = []
            for k, r in self._rings.items():
                if name is None or k == name:
                    cut = r.n % CAPACITY
                    rows = (np.concatenate((r.data[cut:], r.data[:cut])) if r.n > CAPACITY
                            else r.data[:r.n].copy())
                    copies.append((k, rows))
        return [SpanRecord(k, *row[:-1], bool(row[-1]))
                for k, rows in copies for row in rows.tolist()]

    def counters(self) -> Dict[str, Count]:
        """The count and total seconds of every span name recorded, and the
        count of every event counter."""
        with self._lock:
            out = {k: Count(r.n, r.total_ns * 1e-9) for k, r in self._rings.items()}
            out.update({k: Count(n, 0.0) for k, n in self._events.items()})
        return out

    def clear(self) -> None:
        """Forget every record and counter."""
        with self._lock:
            self._rings.clear()
            self._events.clear()

    def timing_report(self) -> str:
        """One line a span name (count, median and total ms, the median a
        scan), then the event counters."""
        lines = []
        for name, c in sorted(self.counters().items()):
            recs = self.spans(name)
            if not recs:
                lines.append(f"{name}: {c.n}")
                continue
            med = statistics.median(r.dur_ns for r in recs) * 1e-6
            per_scan = statistics.median(r.dur_ns / max(r.scans, 1) for r in recs) * 1e-6
            lines.append(f"{name}: n={c.n} median={med:.3f}ms per_scan={per_scan:.3f}ms "
                         f"total={c.seconds * 1e3:.1f}ms")
        return "\n".join(lines)


RECORDER = Recorder()


def enable(on: bool = True) -> None:
    """Turn the process's recorder on or off (on by default)."""
    RECORDER.enabled = bool(on)


def enabled() -> bool:
    return RECORDER.enabled


span = RECORDER.span
phase = RECORDER.phase
record = RECORDER.record
current = RECORDER.current
new_request = RECORDER.new_request
request = RECORDER.request
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
clear = RECORDER.clear
timing_report = RECORDER.timing_report


class FrameTimer:
    """Accumulating named segment timer (getTimeTaken() analog) of the
    serving loop. Each segment is also a span ``server.<name>`` of the
    recorder."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.frames = 0

    @contextlib.contextmanager
    def segment(self, name: str, scans: int = 1) -> Iterator[None]:
        s = RECORDER.span("server." + name, scans=scans, timed=True)
        try:
            with s:
                yield
        finally:
            self.totals[name] += s.seconds

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
