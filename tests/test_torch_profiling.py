"""The port's span recorder (``utils/profiling.py``) and the spans that the
facade, the dispatch layer and the server record through it: fixed memory,
parents and request ids, two threads at once, the off switch, the profiled
flag, profiler ranges only for host-only spans on the profiler's thread
(stamped on the trace's clock), and on the CPU the facade's step split into
its children and the server's queue span under each message's own id."""

from __future__ import annotations

import os
import sys
import threading
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from patchworkpp_tpu_torch import PatchworkPP  # noqa: E402
from patchworkpp_tpu_torch.serve import (  # noqa: E402
    CloudMsg,
    GroundSegmentationServer,
    ServerConfig,
)
from patchworkpp_tpu_torch.utils import profiling  # noqa: E402
from patchworkpp_tpu_torch.utils.profiling import Recorder  # noqa: E402
from test_fuzz_parity import CAP, synth_cloud  # noqa: E402

STEP_CHILDREN = {"facade.stage", "facade.upload", "dispatch.launch", "facade.readback",
                 "facade.unpack"}


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_memory_stays_fixed_over_100000_spans():
    """The ring is made whole at a name's first record; 100,000 more
    records (three times round it) add nothing."""
    tracemalloc.start()
    try:
        rec = Recorder()
        with rec.span("s"):
            pass
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(100_000):
            with rec.span("s"):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    ring_bytes = profiling.CAPACITY * (len(profiling.SpanRecord._fields) - 1) * 8
    assert before >= ring_bytes, before
    assert grown < 16 * 1024, grown
    kept = rec.spans("s")
    assert len(kept) == profiling.CAPACITY == 32768
    assert rec.counters()["s"].n == 100_001
    ids = [r.id for r in kept]
    assert ids == sorted(ids) and ids[-1] == 100_001
    assert not any(r.profiled for r in kept) and all(r.scans == 1 for r in kept)


def test_parents_requests_and_recorded_spans():
    rec = Recorder()
    with rec.span("outer", scans=3) as outer:
        with rec.span("inner") as a:
            pass
        with rec.span("inner") as b:
            rec.record("later", start_ns=5, dur_ns=7)
    with rec.span("outer"):
        pass
    rid = rec.new_request()
    with rec.request(rid):
        with rec.span("in_request") as c:
            pass
        rec.record("queued", start_ns=1, dur_ns=2, parent=0)
    first, second = rec.spans("outer")
    assert first.id == outer.id and first.parent == 0 and first.scans == 3
    assert [r.parent for r in rec.spans("inner")] == [outer.id, outer.id]
    assert {r.request for r in rec.spans("inner")} == {first.request}
    assert {a.id, b.id, outer.id} == {r.id for r in rec.spans("inner")} | {first.id}
    later = rec.spans("later")[0]
    assert (later.parent, later.request, later.start_ns, later.dur_ns) == (b.id, first.request,
                                                                          5, 7)
    assert second.request != first.request and second.parent == 0
    assert rec.spans("in_request")[0].request == rid and c.seconds >= 0
    assert rec.spans("queued")[0].request == rid
    assert rec.counters()["outer"].n == 2
    assert rec.counters()["outer"].seconds == pytest.approx(
        sum(r.dur_ns for r in rec.spans("outer")) * 1e-9)
    rec.count("events", 3)
    assert rec.counters()["events"] == (3, 0.0)
    assert "outer" in rec.timing_report() and "events: 3" in rec.timing_report()


def test_threads_record_at_once():
    """More threads than cores, switching often: no record or count is
    lost, and each inner span's parent is the outer span of its thread."""
    rec = Recorder()
    tags = [f"t{i}" for i in range(max(2, (os.cpu_count() or 1) + 1))]
    n = 1000
    start = threading.Barrier(len(tags))

    def work(tag):
        start.wait()
        for _ in range(n):
            with rec.span("outer." + tag):
                with rec.span("inner", scans=int(tag[1:])):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in tags]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    inner = rec.spans("inner")
    assert rec.counters()["inner"].n == len(inner) == len(tags) * n
    assert rec.counters()["inner"].seconds == pytest.approx(sum(r.dur_ns for r in inner) * 1e-9)
    outer = {r.id: (t, r) for t in tags for r in rec.spans("outer." + t)}
    assert len(outer) == len(tags) * n
    for r in inner:
        tag, parent = outer[r.parent]
        assert parent.request == r.request and int(tag[1:]) == r.scans
    assert len({r.id for r in inner}) == len(inner)


def test_enable_false_records_nothing_but_timed_spans_still_time():
    rec = Recorder()
    rec.enabled = False
    with rec.span("x"):
        pass
    with rec.span("t", timed=True) as t:
        time.sleep(0.002)
    rec.record("r", 0, 1)
    rec.count("c")
    assert rec.spans() == [] and rec.counters() == {}
    assert t.seconds >= 0.002
    profiling.enable(False)
    try:
        assert not profiling.enabled()
        m = PatchworkPP(capacity=CAP, device="cpu")
        n0 = profiling.counters().get("facade.step", profiling.Count(0, 0.0)).n
        r = m.estimate_ground(synth_cloud(0, exact_edges=False))
        assert r.time_taken_s > 0
        assert profiling.counters().get("facade.step", profiling.Count(0, 0.0)).n == n0
    finally:
        profiling.enable(True)


def test_the_profiled_flag_follows_the_profiler():
    rec = Recorder()
    with rec.span("before"):
        pass
    with _profile():
        with rec.span("during"):
            pass
        rec.record("recorded", 0, 1)
    assert [r.profiled for r in rec.spans()] == [False, True, True]


def test_only_host_only_spans_open_a_range_stamped_on_the_trace_clock():
    rec = Recorder()
    with _profile() as prof:
        with rec.span("warm", host_only=True):  # the first range's one-off set-up
            pass
        with rec.span("host.work", host_only=True):
            sum(range(20000))
        with rec.span("device.work"):
            sum(range(20000))
    names = [e.name for e in prof.events()]
    assert "host.work" in names and "device.work" not in names
    ev = next(e for e in prof.events() if e.name == "host.work")
    trace_start_ns = prof.profiler.kineto_results.trace_start_ns()
    on_trace_ns = trace_start_ns + ev.time_range.start * 1e3
    assert abs(on_trace_ns - rec.spans("host.work")[0].start_ns) < 1e6


def test_a_span_on_another_thread_is_recorded_without_a_range():
    rec = Recorder()

    def work():
        with rec.span("worker.work", host_only=True):
            sum(range(20000))

    with _profile() as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert "worker.work" not in [e.name for e in prof.events()]
    (r,) = rec.spans("worker.work")
    assert r.profiled


def _step_children(step):
    return [r for r in profiling.spans() if r.parent == step.id]


@pytest.mark.parametrize("sequence", [False, True], ids=["frame", "sequence"])
def test_the_facade_step_splits_into_its_children(sequence):
    m = PatchworkPP(capacity=CAP, device="cpu")
    clouds = [synth_cloud(s, exact_edges=False) for s in range(3)]
    m.estimate_ground(clouds[0])  # builds the frame outside the measured step
    if sequence:
        res = m.estimate_ground_sequence(clouds)
    else:
        res = [m.estimate_ground(clouds[1])]
    step = profiling.spans("facade.step")[-1]
    assert step.scans == len(res)
    assert res[0].time_taken_s == step.seconds
    children = _step_children(step)
    assert {r.name for r in children} == STEP_CHILDREN and len(children) == 5
    assert all(r.request == step.request and r.scans == len(res) for r in children)
    assert sum(r.dur_ns for r in children) == pytest.approx(step.dur_ns, rel=0.05)
    assert all(r.time_taken_s == 0.0 for r in res[1:])


def test_the_server_gives_each_message_a_queue_span_under_its_own_id():
    clouds = [synth_cloud(s, exact_edges=False) for s in range(3)]
    srv = GroundSegmentationServer(config=ServerConfig(capacity=CAP), device="cpu")
    done = threading.Event()
    got = []

    def cb(out):
        got.append(out)
        if len(got) == len(clouds):
            done.set()

    srv.on_result(cb)
    seen = profiling.counters().get("server.queue", profiling.Count(0, 0.0)).n
    with srv:
        for c in clouds:
            srv.publish(CloudMsg(points=c, stamp=time.time()))
            time.sleep(0.05)
        assert done.wait(120)
    assert profiling.counters()["server.queue"].n == seen + 3
    queued = profiling.spans("server.queue")[-3:]
    ids = [r.request for r in queued]
    assert len(set(ids)) == 3 and all(r.parent == 0 for r in queued)
    steps = {r.request: r for r in profiling.spans("facade.step")}
    answers = {r.request for r in profiling.spans("server.answer")}
    for r, out in zip(queued, got):
        assert r.request in steps and r.request in answers
        assert steps[r.request].seconds == out.result.time_taken_s
        assert r.seconds <= out.latency_s
    assert "server.queue" in srv.timing_report()
