"""The port's serving layer on the CPU: GroundSegmentationServer,
MultiStreamSegmenter and the ROS 2 bridge (with the fake rclpy modules of
tests/test_ros2_bridge.py), ports of tests/test_serve_io.py:54-147 and
tests/test_facade_transport.py:70-100.

Inputs are tests/test_fuzz_parity.py:synth_cloud and sparse cuts of the
synthetic 64-beam scan, PyTorch on one thread. A streamed chain's labels must
equal the JAX tiled engine's frame by frame (state floats within
test_torch_frame.py's tolerances); the other paths must equal the port's
own facade bit for bit, which the facade and frame tests hold to JAX.

Three behaviours of the port's server differ from the JAX server's on
purpose (its faults, VERDICT.md "What's weak" #1, #2 and #5), and are stated
here: a scan that raises is answered with an error result and the worker
keeps serving; a batch_max the queue cannot fill is refused; latency_s runs
from publish() and includes the wait in the queue.
"""

from __future__ import annotations

import importlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn
from patchworkpp_tpu.serve import MultiStreamSegmenter as JMultiStreamSegmenter
from patchworkpp_tpu_torch import Params, PatchworkPP
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.serve import (
    CloudMsg,
    GroundSegmentationServer,
    MultiStreamSegmenter,
    ServerConfig,
)
from test_fuzz_parity import CAP, synth_cloud
from test_ros2_bridge import (  # noqa: F401  (the fake-rclpy fixture)
    _SENSOR_DATA_QOS,
    _Dur,
    _FakePointCloud2,
    _Header,
    _Rel,
    bridge,
)
from test_torch_frame import _assert_state_close, _one_torch_thread  # noqa: F401

TIMEOUT = 120.0


def _clouds(seed=0, n=3):
    return [synth_cloud(seed + 5 * k, exact_edges=False) for k in range(n)]


def _server(**cfg):
    return GroundSegmentationServer(config=ServerConfig(**{"capacity": CAP, **cfg}),
                                    device="cpu")


def _collect(srv, n):
    """Subscribe; returns (results list, event set when n have arrived)."""
    got, done = [], threading.Event()

    def cb(out):
        got.append(out)
        if len(got) == n:
            done.set()

    srv.on_result(cb)
    return got, done


def test_server_stream_matches_jax_engine():
    clouds = _clouds(0)
    srv = _server()
    got, done = _collect(srv, 3)
    with srv:
        for c in clouds:
            srv.publish(CloudMsg(points=c, stamp=time.time()))
        assert done.wait(TIMEOUT), "server did not process 3 frames in time"
    assert srv.frames_processed == 3 and srv.frames_dropped == 0
    assert srv.timer.frames == 3 and srv.timer.totals["infer"] > 0
    assert "infer" in srv.timing_report()
    assert srv.sensor_height != Params().sensor_height

    jfn = jax.jit(j_make_frame_fn(JParams()))
    js = jstate.init_state(JParams())
    for i, (c, out) in enumerate(zip(clouds, got)):
        pts = np.zeros((CAP, 4), np.float32)
        pts[: len(c)] = c
        js, jr = jfn(js, jnp.asarray(pts), jnp.int32(len(c)))
        assert out.msg.points is c
        np.testing.assert_array_equal(out.result.ground_mask,
                                      np.asarray(jr.ground_mask)[: len(c)], err_msg=f"frame {i}")
        assert out.result.ground_indices.size + out.result.nonground_indices.size == len(c)
    _assert_state_close(js, srv._model.state, "streamed chain vs jax")


def test_server_sync_process_and_device():
    srv = _server()
    assert srv.device.type == "cpu"
    out = srv.process(CloudMsg(points=synth_cloud(1, exact_edges=False), stamp=0.0))
    assert out.result.ground_indices.size > 0 and out.latency_s > 0


def test_server_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GroundSegmentationServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStreamSegmenter()


def test_server_checkpoint_restart(tmp_path):
    """A restarted server resuming from a checkpoint continues the chain
    exactly: frame 3 after restore == frame 3 without."""
    a, b, c = _clouds(2)
    srv1 = _server()
    srv1.process(CloudMsg(points=a, stamp=0.0))
    srv1.process(CloudMsg(points=b, stamp=1.0))
    path = str(tmp_path / "server_state.npz")
    srv1.save_state(path)
    r_cont = srv1.process(CloudMsg(points=c, stamp=2.0))
    srv2 = _server()
    srv2.load_state(path)
    r_resume = srv2.process(CloudMsg(points=c, stamp=2.0))
    np.testing.assert_array_equal(r_resume.result.ground_mask, r_cont.result.ground_mask)
    assert srv2.sensor_height == srv1.sensor_height


def test_server_requires_start():
    with pytest.raises(RuntimeError, match="not started"):
        _server().publish(CloudMsg(points=synth_cloud(0, exact_edges=False), stamp=0.0))


def test_server_backlog_batching_matches_sequential():
    """A queued backlog drains through sequence calls of batch_max; labels
    and the adapted state equal the per-frame path."""
    clouds = _clouds(3, 4)
    srv = _server(queue_depth=8, batch_max=2)
    got, done = _collect(srv, len(clouds))
    srv.start()
    for c in clouds:
        srv.publish(CloudMsg(points=c, stamp=time.time()))
    assert done.wait(TIMEOUT), "server did not process the backlog"
    srv.stop()
    assert srv.frames_processed == len(clouds)
    ref = PatchworkPP(capacity=CAP, device="cpu")
    for out, c in zip(got, clouds):
        np.testing.assert_array_equal(out.result.ground_mask, ref.estimate_ground(c).ground_mask)
    assert srv.sensor_height == ref.sensor_height


def test_mixed_density_stream_on_one_server():
    """Interleaved dense and sparse scans through one fixed-capacity server,
    each taking its own upload bucket (16384, 8192, 8192 of 32768), equal
    the per-scan facade's labels and adaptation chain."""
    feed = [make_scan(0, 0)[::8], synth_cloud(4, exact_edges=False), make_scan(0, 1)[::16]]
    srv = _server(capacity=32768)
    got, done = _collect(srv, len(feed))
    with srv:
        for c in feed:
            srv.publish(CloudMsg(points=c, stamp=0.0))
        assert done.wait(TIMEOUT)
    ref = PatchworkPP(capacity=32768, device="cpu")
    for c, out in zip(feed, got):
        np.testing.assert_array_equal(out.result.ground_mask, ref.estimate_ground(c).ground_mask)
    assert srv.sensor_height == ref.sensor_height


def test_worker_ends_on_a_scan_that_raises(monkeypatch):
    """The JAX server's worker ends on a scan that raises (VERDICT "What's
    weak" #1; the test's name states that behaviour) and leaves later
    messages unanswered. The port's does not: a scan over the fixed capacity
    is answered with result None and its ValueError, worker_error keeps it,
    the worker stays alive and the next message is answered with the labels
    of a facade that never saw the bad scan."""
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda a: seen.append(a.exc_value))
    srv = _server()
    got, done = _collect(srv, 2)
    good = synth_cloud(0, exact_edges=False)
    with srv:
        srv.publish(CloudMsg(points=np.zeros((CAP + 1, 4), np.float32), stamp=0.0))
        srv.publish(CloudMsg(points=good, stamp=1.0))
        assert done.wait(TIMEOUT), "the message after the bad scan was not answered"
        assert srv.worker_alive
    bad, ok = got
    assert bad.result is None and isinstance(bad.error, ValueError)
    assert "capacity" in str(bad.error) and srv.worker_error is bad.error
    assert ok.error is None and ok.msg.stamp == 1.0
    ref = PatchworkPP(capacity=CAP, device="cpu")
    np.testing.assert_array_equal(ok.result.ground_mask, ref.estimate_ground(good).ground_mask)
    assert srv.sensor_height == ref.sensor_height
    assert srv.frames_processed == 2 and seen == []


def test_batch_max_over_queue_depth_never_batches():
    """The JAX server accepts a batch_max its queue cannot fill and then
    never batches (VERDICT "What's weak" #2; the test's name states that
    behaviour): a busy worker comes back to at most queue_depth waiting
    messages. The port refuses such a config; at batch_max == queue_depth a
    held worker's backlog runs as one sequence call."""
    with pytest.raises(ValueError, match="queue_depth"):
        ServerConfig(queue_depth=2, batch_max=3)
    with pytest.raises(ValueError, match="queue_depth"):
        ServerConfig(queue_depth=4, batch_max=6)
    srv = _server(queue_depth=2, batch_max=2)
    seq_calls = []
    seq = srv._model.estimate_ground_sequence
    srv._model.estimate_ground_sequence = lambda clouds: seq_calls.append(len(clouds)) or seq(clouds)
    entered, release = threading.Event(), threading.Event()
    got = []

    def cb(out):
        got.append(out)
        if len(got) == 1:  # hold the worker while the backlog builds up
            entered.set()
            release.wait(TIMEOUT)

    srv.on_result(cb)
    clouds = _clouds(1, 5)
    with srv:
        srv.publish(CloudMsg(points=clouds[0], stamp=0.0))
        assert entered.wait(TIMEOUT)
        for i, c in enumerate(clouds[1:], 1):
            srv.publish(CloudMsg(points=c, stamp=float(i)))  # drop-oldest at depth 2
        release.set()
        t_end = time.time() + TIMEOUT
        while len(got) < 3 and time.time() < t_end:
            time.sleep(0.02)
    assert srv.frames_dropped == 2
    assert [out.msg.stamp for out in got] == [0.0, 3.0, 4.0]
    assert seq_calls == [2]


def test_latency_includes_the_wait_in_the_queue():
    """latency_s runs from publish() to the answer, per message: a message
    published while the worker is held answers with a latency that covers
    the hold. (The JAX server reports the batch's inference time for every
    message, without the wait: VERDICT "What's weak" #5.)"""
    srv = _server()
    entered, release = threading.Event(), threading.Event()
    got = []
    hold_s = 0.5

    def cb(out):
        got.append(out)
        if len(got) == 1:
            entered.set()
            release.wait(TIMEOUT)

    srv.on_result(cb)
    with srv:
        srv.publish(CloudMsg(points=synth_cloud(0, exact_edges=False), stamp=0.0))
        assert entered.wait(TIMEOUT)
        t_pub = time.perf_counter()
        srv.publish(CloudMsg(points=synth_cloud(1, exact_edges=False), stamp=1.0))
        time.sleep(hold_s)
        release.set()
        t_end = time.time() + TIMEOUT
        while len(got) < 2 and time.time() < t_end:
            time.sleep(0.02)
        t_back = time.perf_counter()
    assert len(got) == 2 and got[1].msg.stamp == 1.0
    assert hold_s <= got[1].latency_s <= t_back - t_pub


def test_multi_stream_isolated_states_and_checkpoint(tmp_path):
    a, b = _clouds(0), _clouds(1)
    ms = MultiStreamSegmenter(capacity=CAP, device="cpu")
    fa = PatchworkPP(capacity=CAP, device="cpu")
    fb = PatchworkPP(capacity=CAP, device="cpu")
    for i in range(2):  # interleaved
        np.testing.assert_array_equal(ms.segment("a", a[i]).ground_mask,
                                      fa.estimate_ground(a[i]).ground_mask)
        np.testing.assert_array_equal(ms.segment("b", b[i]).ground_mask,
                                      fb.estimate_ground(b[i]).ground_mask)
    assert ms.streams == ["a", "b"]
    assert ms.sensor_height("a") == fa.sensor_height
    assert ms.sensor_height("b") == fb.sensor_height != fa.sensor_height

    path = str(tmp_path / "streams.npz")
    ms.save_states(path)
    back = MultiStreamSegmenter(capacity=CAP, device="cpu")
    back.load_states(path)
    np.testing.assert_array_equal(back.segment("a", a[2]).ground_mask,
                                  fa.estimate_ground(a[2]).ground_mask)
    assert back.sensor_height("a") == fa.sensor_height

    # the JAX package's multiplexer resumes the port's checkpoint
    j = JMultiStreamSegmenter(capacity=CAP)
    j.load_states(path)
    assert sorted(j.streams) == ["a", "b"]
    for sid in ("a", "b"):
        want = ms._states[sid].to_numpy()
        for k, v in j._states[sid].to_numpy().items():
            np.testing.assert_array_equal(v, want[k], err_msg=f"{sid} {k}")

    ms.reset("a")
    assert ms.streams == ["b"]
    np.testing.assert_array_equal(
        ms.segment("a", a[0]).ground_mask,
        PatchworkPP(capacity=CAP, device="cpu").estimate_ground(a[0]).ground_mask)


# ---------------------------------------------------------------- ROS 2 bridge


@pytest.fixture()
def port_bridge(bridge):  # noqa: F811
    """The port's bridge, reloaded with the fake rclpy modules that the JAX
    bridge test installs; reloaded again without them afterwards."""
    import patchworkpp_tpu_torch.serve.ros2_bridge as rb

    rb = importlib.reload(rb)
    assert rb.HAVE_ROS2
    yield rb
    for name in [n for n in sys.modules
                 if n.split(".")[0] in ("rclpy", "sensor_msgs", "sensor_msgs_py",
                                        "std_msgs", "builtin_interfaces")]:
        sys.modules.pop(name, None)
    assert not importlib.reload(rb).HAVE_ROS2


def _node(rb):
    return rb.PatchworkppNode(device="cpu", config=ServerConfig(capacity=CAP))


def _wait_published(pub):
    t_end = time.time() + TIMEOUT
    while time.time() < t_end and not pub.messages:
        time.sleep(0.02)
    assert pub.messages, f"nothing published on {pub.topic}"
    return pub.messages[0]


def test_bridge_round_trip(port_bridge):
    node = _node(port_bridge)
    try:
        pts = synth_cloud(0, exact_edges=False)[:, :3].copy()
        msg = _FakePointCloud2(pts, _Header())
        assert {t for t, _ in node.subscriptions} == {"pointcloud_topic"}
        pubs = {p.topic: p for p in node.publishers}
        assert set(pubs) == {"/patchworkpp/cloud", "/patchworkpp/ground",
                             "/patchworkpp/nonground"}
        node._on_cloud(msg)
        assert pubs["/patchworkpp/cloud"].messages == [msg]
        g = _wait_published(pubs["/patchworkpp/ground"])
        ng = _wait_published(pubs["/patchworkpp/nonground"])
        assert len(g._pts) + len(ng._pts) == len(pts)
        both = np.concatenate([g._pts, ng._pts])
        assert np.array_equal(np.sort(both.view([("", both.dtype)] * 3).ravel()),
                              np.sort(pts.view([("", pts.dtype)] * 3).ravel()))
        assert g.header.frame_id == "base_link" and g.header.stamp.sec == 7
        want = PatchworkPP(capacity=CAP, device="cpu").estimate_ground(pts)
        np.testing.assert_array_equal(g._pts, pts[want.ground_indices])
    finally:
        node.server.stop()


def test_bridge_intensity_enables_rnr(port_bridge):
    """An intensity-bearing PointCloud2 runs RNR: the published ground cloud
    equals the facade's RNR-on labels, which differ from RNR off."""
    pts4 = synth_cloud(0, exact_edges=False)
    pts4[:4] = [[3.1, 0.0, -3.4, 0.05], [0.0, 3.6, -3.6, 0.01],
                [-2.9, 0.9, -3.5, 0.10], [2.5, -2.5, -3.3, 0.0]]
    on = PatchworkPP(Params(enable_RNR=True), capacity=CAP, device="cpu").estimate_ground(pts4)
    off = PatchworkPP(Params(enable_RNR=False), capacity=CAP, device="cpu").estimate_ground(pts4)
    assert not np.array_equal(on.ground_mask, off.ground_mask)
    node = _node(port_bridge)
    try:
        node._on_cloud(_FakePointCloud2(pts4, _Header(),
                                        field_names=("x", "y", "z", "intensity")))
        g = _wait_published({p.topic: p for p in node.publishers}["/patchworkpp/ground"])
        np.testing.assert_array_equal(g._pts, pts4[on.ground_mask][:, :3])
    finally:
        node.server.stop()


def test_bridge_qos_and_params_match_reference(port_bridge):
    node = _node(port_bridge)
    try:
        assert node.sub_qos["pointcloud_topic"] is _SENSOR_DATA_QOS
        for topic in ("/patchworkpp/cloud", "/patchworkpp/ground", "/patchworkpp/nonground"):
            q = node.pub_qos[topic]
            assert (q.reliability, q.durability, q.depth) == (
                _Rel.RELIABLE, _Dur.TRANSIENT_LOCAL, 10), topic
        assert set(node.declared_params) == {
            "verbose", "sensor_height", "num_iter", "num_lpr", "num_min_pts",
            "th_seeds", "th_dist", "th_seeds_v", "th_dist_v", "max_range",
            "min_range", "uprightness_thr", "base_frame", "enable_RNR",
        }
        assert node.declared_params["enable_RNR"] is True
        assert node.server.params.verbose is False
        assert node.server.device.type == "cpu"
    finally:
        node.server.stop()
