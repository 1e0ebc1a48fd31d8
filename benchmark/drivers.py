"""The one general generator: a traffic mix's parameters drive the program
through one of its public entry points, closed loop, for the window's
seconds, and keep the outputs that the correctness check compares.

Two entries, named by the mix's ``entry``:

- ``sequence``: ``PatchworkPP.estimate_ground_sequence`` over calls of
  ``call_scans`` consecutive scans of the drive, one call after another,
  the adaptive state chained across calls;
- ``server``: ``GroundSegmentationServer`` (``batch_max``, ``queue_depth``),
  each scan published once the last one's callback has run; latency is
  publish to callback on the host clock.

Both go round the drive's scan cycle. Scan ``g`` of the window is
``cycle[g % len(cycle)]``. What is kept for the check (``check`` in the
mix): the first ``start_scans`` outputs and the state after them, from the
fresh state the reference starts from; and ``samples`` later places drawn
from the seed, each with the state before it, its outputs and (server) the
state after it. Where the window closes before the last sampled place, the
mix goes on past the close, untimed, until that place is answered (at most
``ANSWER_TIMEOUT_S`` more): a slow run is checked on as many places as a
fast one, and a place never answered leaves the kept outputs incomplete.

A traced run (``tracer``) profiles the mix's slice (``trace_from``, and
``trace_calls`` calls or ``trace_scans`` scans), runs on past the window's
seconds until the slice is whole, and leaves the slice's scans out of its
host timings.
"""

from __future__ import annotations

import dataclasses
import io
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.trace import SPAN_PREFIX, Tracer

ANSWER_TIMEOUT_S = 60.0


@dataclasses.dataclass
class Output:
    mask: np.ndarray      # (N,) bool ground labels
    centers: np.ndarray   # (K, 3) processed patches' plane centers
    normals: np.ndarray   # (K, 3) and normals


@dataclasses.dataclass
class Sample:
    first: int                     # window index of its first scan
    state_before: dict
    outputs: List[Output]
    state_after: Optional[dict] = None


@dataclasses.dataclass
class Kept:
    start: List[Output] = dataclasses.field(default_factory=list)
    start_state: Optional[dict] = None
    samples: List[Sample] = dataclasses.field(default_factory=list)
    states_after: bool = False     # whether each sample keeps the state after it

    def complete(self, check: dict) -> bool:
        """Every output and state the check compares was kept."""
        return (len(self.start) == check["start_scans"] and self.start_state is not None
                and len(self.samples) == check["samples"]
                and all(len(s.outputs) == check.get("sample_scans", 1) for s in self.samples)
                and (not self.states_after
                     or all(s.state_after is not None for s in self.samples)))


@dataclasses.dataclass
class RunRecord:
    """What a run measured; the metrics' readers take their numbers here."""

    setup_s: float = 0.0
    window_s: float = 0.0
    scans: int = 0                 # scans whose results reached the host
    attempted: int = 0
    failed: int = 0
    latency_s: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)  # server scans
    handoff_s: List[float] = dataclasses.field(default_factory=list)
    setup_marks: Dict[str, float] = dataclasses.field(default_factory=dict)  # s from start
    trace: object = None           # trace.TraceRecord of the traced slice
    k1_least_s: Optional[float] = None  # K1's least time a launch
    memory_peak_bytes: int = 0


def sample_places(seed: int, check: dict) -> List[int]:
    """The window places (calls or scans) the check samples, drawn from the
    seed before the window among ``[sample_from, sample_span)``."""
    rng = np.random.default_rng([seed, 0x5A])
    lo, hi = check["sample_from"], check["sample_span"]
    return sorted(int(v) for v in rng.choice(np.arange(lo, hi), check["samples"],
                                             replace=False))


def _output(res) -> Output:
    return Output(res.ground_mask, res.centers, res.normals)


def _state(obj) -> dict:
    """The program's adaptive state through its public checkpoint call."""
    buf = io.BytesIO()
    obj.save_state(buf)
    buf.seek(0)
    with np.load(buf) as d:
        return {k: d[k] for k in d.files}


def run_sequence(sut, cycle, mix, seconds, seed, tracer: Optional[Tracer], rec: RunRecord,
                 t_origin: float) -> Kept:
    n = mix["call_scans"]
    if len(cycle) % n:
        raise ValueError(f"the cycle of {len(cycle)} scans is not whole calls of {n}")
    calls = [cycle[i:i + n] for i in range(0, len(cycle), n)]
    check = mix["check"]
    m = sut.facade()
    rec.setup_marks["built"] = time.perf_counter() - t_origin
    for _ in range(mix["warmup_calls"]):
        m.estimate_ground_sequence(calls[0])
    m.reset()
    sampled = sample_places(seed, check)
    snap = set(sampled) | {1}
    states: Dict[int, dict] = {}
    kept = Kept()
    trace_from, trace_to = mix["trace_from"], mix["trace_from"] + mix["trace_calls"]
    import torch

    rec.setup_s = time.perf_counter() - t_origin
    t0 = time.perf_counter()
    t_close = None                 # the window's close, once it has come
    last = max(sampled, default=-1)
    k = 0
    while True:
        if k in snap:
            states[k] = _state(m)
        if tracer and k == trace_from:
            tracer.start()
        rec.attempted += n
        with torch.profiler.record_function(SPAN_PREFIX + "sequence_call"):
            res = m.estimate_ground_sequence(calls[k % len(calls)])
        if t_close is None:
            rec.scans += len(res)
        if tracer and k + 1 == trace_to:
            tracer.stop(scans=n * mix["trace_calls"])
        if k == 0:
            kept.start = [_output(r) for r in res[: check["start_scans"]]]
        if k in sampled:
            kept.samples.append(Sample(k * n, states[k],
                                       [_output(r) for r in res[: check["sample_scans"]]]))
        k += 1
        now = time.perf_counter()
        if t_close is None and now - t0 >= seconds and not (tracer and k < trace_to):
            t_close = now
            rec.window_s = now - t0
        if t_close is not None and (k > last or now - t_close >= ANSWER_TIMEOUT_S):
            break
    if check["start_scans"] == n and 1 in states:
        kept.start_state = states[1]
    return kept


class _Answers:
    """The server's callback: the answer and its arrival on the host clock."""

    def __init__(self) -> None:
        self.event = threading.Event()
        self.msg = None
        self.t = 0.0

    def __call__(self, msg) -> None:
        self.t = time.perf_counter()
        self.msg = msg
        self.event.set()


def run_server(sut, cycle, mix, seconds, seed, tracer: Optional[Tracer], rec: RunRecord,
               t_origin: float) -> Kept:
    check = mix["check"]
    srv = sut.server(batch_max=mix["batch_max"], queue_depth=mix["queue_depth"])
    answers = _Answers()
    srv.on_result(answers)
    fresh = io.BytesIO()
    srv.save_state(fresh)

    def serve_one(g: int):
        answers.event.clear()
        t_pub = time.perf_counter()
        srv.publish(sut.message(cycle[g % len(cycle)], t_pub))
        if not answers.event.wait(ANSWER_TIMEOUT_S):
            return None, None
        return answers.msg, answers.t - t_pub

    srv.start()
    rec.setup_marks["built"] = time.perf_counter() - t_origin
    try:
        for g in range(mix["warmup_scans"]):
            msg, _ = serve_one(g)
            if msg is None or msg.error is not None:
                raise RuntimeError(f"warm-up scan {g} failed: "
                                   f"{None if msg is None else msg.error!r}")
        fresh.seek(0)
        srv.load_state(fresh)
        sampled = sample_places(seed, check)
        snap = {check["start_scans"]} | set(sampled) | {s + 1 for s in sampled}
        states: Dict[int, dict] = {}
        kept = Kept(states_after=True)
        outs: Dict[int, Output] = {}
        trace_from, trace_to = mix["trace_from"], mix["trace_from"] + mix["trace_scans"]
        import torch

        rec.setup_s = time.perf_counter() - t_origin
        t0 = time.perf_counter()
        t_close = None             # the window's close, once it has come
        last = max(sampled, default=-1)
        g = 0
        while True:
            if g in snap:
                states[g] = _state(srv)
            if tracer and g == trace_from:
                tracer.start()
            rec.attempted += 1
            with torch.profiler.record_function(SPAN_PREFIX + "publish_to_callback"):
                msg, lat = serve_one(g)
            if msg is None:  # never answered: the worker is stuck
                rec.failed += 1
                break
            if msg.error is not None or msg.result is None:
                rec.failed += 1
            else:
                # timed: the window's scans but the profiled slice
                if t_close is None:
                    rec.scans += 1
                    if not (tracer and trace_from <= g < trace_to):
                        rec.latency_s.append(lat)
                        rec.step_s.append(msg.result.time_taken_s)
                        rec.handoff_s.append(lat - msg.result.time_taken_s)
                if g < check["start_scans"] or g in sampled:
                    outs[g] = _output(msg.result)
            if tracer and g + 1 == trace_to:
                tracer.stop(scans=mix["trace_scans"])
            g += 1
            now = time.perf_counter()
            if t_close is None and now - t0 >= seconds and not (tracer and g < trace_to):
                t_close = now
                rec.window_s = now - t0
            if t_close is not None and (g > last or now - t_close >= ANSWER_TIMEOUT_S):
                break
        if t_close is None:
            rec.window_s = time.perf_counter() - t0
        if g in snap:
            states[g] = _state(srv)
    finally:
        srv.stop()
    kept.start = [outs[i] for i in range(check["start_scans"]) if i in outs]
    kept.start_state = states.get(check["start_scans"])
    for s in sampled:
        if s in outs and s + 1 in states:
            kept.samples.append(Sample(s, states[s], [outs[s]], states[s + 1]))
    return kept


ENTRIES = {"sequence": run_sequence, "server": run_server}
