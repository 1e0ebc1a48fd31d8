"""The ROS 2 launch-file profile (``models/presets.py:ros_launch_params``,
``num_min_pts`` 0) against the port's NumPy oracle: every patch of the CZM
is processed, the empty ones too, and the C++ reference's plane members
carry from patch to patch and from scan to scan (``estimate_plane`` returns
early on an empty input, patchworkpp.cpp:49; ``pipeline.carry_planes``).

The clouds are ``io/synthetic.make_scan(0, f)`` thinned to every 16th
point, at capacity 8192, with the points of patches that hold 2 to 4 points
taken out: a fit of exactly two points has a solver-arbitrary normal
(``NumpyPatchworkpp.two_point_fits``), which an empty patch after it would
inherit, so the oracle's planes are defined only where no fit has two
points. What is left has ~250 empty patches and ~25 one-point patches a
scan, whose fit the reference leaves NaN.

This file imports no JAX: its card test runs on a machine with the card
and without JAX, past tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_launch_profile.py
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu_torch import Params, PatchworkPP
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.models.presets import ros_launch_params
from patchworkpp_tpu_torch.oracle import NumpyPatchworkpp
from patchworkpp_tpu_torch.state import PLANE_WIDTH
from patchworkpp_tpu_torch.utils import profiling

CAP = 8192
FRAMES = 3
CENTER_ATOL = 1e-5   # means of the same points (tests/test_torch_presets_compat.py)
NORMAL_ATOL = 2e-3   # a clustered pair's normal differs in its last bits
STATE_ATOL = 1e-5    # the oracle's statistics are float64 over float32 samples
ZONE0_RING0 = 16     # patches 0-15: zone 0's first ring, the first in flat order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def thin_indeterminate(cloud: np.ndarray, params: Params, most: int = 4) -> np.ndarray:
    """``cloud`` without the points of patches that hold 2 to ``most``
    points (the oracle's binning), where the fits that have exactly two
    points lie."""
    pid, _ = NumpyPatchworkpp(params)._czm_assign(cloud, np.zeros(len(cloud), bool))
    held = np.bincount(pid[pid >= 0], minlength=int(pid.max()) + 1)[np.maximum(pid, 0)]
    return cloud[~((pid >= 0) & (held >= 2) & (held <= most))]


def _scans():
    p = ros_launch_params()
    return [thin_indeterminate(make_scan(0, f)[::16].copy(), p) for f in range(FRAMES)]


def _oracle_frame(o: NumpyPatchworkpp, cloud: np.ndarray) -> dict:
    labels = o.estimate_ground(cloud)
    ids = o.last_patch_id
    held = np.bincount(ids[ids >= 0], minlength=len(o.centers))
    pl = o._plane
    return dict(labels=labels, centers=np.array(o.centers), normals=np.array(o.normals),
                empty=int((held[:len(o.centers)] == 0).sum()),
                plane=np.concatenate([pl.mean, pl.normal, pl.svals, [pl.d]]),
                elev=[list(b) for b in o.update_elevation],
                flat=[list(b) for b in o.update_flatness],
                sensor_height=o.sensor_height, elevation_thr=list(o.elevation_thr),
                flatness_thr=list(o.flatness_thr))


@pytest.fixture(scope="module")
def chain():
    """The scans and the oracle's frames over them, chained."""
    scans = _scans()
    o = NumpyPatchworkpp(ros_launch_params())
    frames = [_oracle_frame(o, s) for s in scans]
    assert o.two_point_fits == 0
    return scans, frames


def _assert_planes(got_c, got_n, want_c, want_n, label):
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=CENTER_ATOL, err_msg=label)
    # assert_allclose holds NaN equal to NaN: a one-point fit and the empty
    # patches after it
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=NORMAL_ATOL, err_msg=label)


def _assert_state(m: PatchworkPP, want: dict, label: str):
    st = m.state.to_numpy()
    for name, key in (("elev", "elev"), ("flat", "flat")):
        cnt = st[f"{key}_cnt"]
        assert cnt.tolist() == [len(b) for b in want[name]], (label, name)
        for ring, b in enumerate(want[name]):
            np.testing.assert_allclose(st[f"{key}_buf"][ring, :cnt[ring]], b, rtol=0,
                                       atol=STATE_ATOL, err_msg=f"{label} {name} {ring}")
    for k in ("sensor_height", "elevation_thr", "flatness_thr"):
        np.testing.assert_allclose(st[k], want[k], rtol=0, atol=STATE_ATOL, err_msg=label)
    np.testing.assert_allclose(st["plane"], want["plane"], rtol=0, atol=NORMAL_ATOL,
                               err_msg=f"{label} plane")


@pytest.mark.parametrize("engine, chunks", [(None, 1), ("onehot", 1), (False, 1), (None, 2)],
                         ids=["tiled", "onehot", "unfused", "chunked"])
def test_launch_profile_matches_oracle(chain, engine, chunks):
    """Labels equal, every processed plane (inherited and NaN ones too)
    within the tolerances, the rings' samples and the carried plane equal,
    over three chained scans; the chunked frame carries the planes on its
    merged per-patch tables."""
    scans, frames = chain
    m = PatchworkPP(ros_launch_params(), capacity=CAP, device="cpu", fused=engine,
                    chunks=chunks)
    nan = 0
    for k, (scan, want) in enumerate(zip(scans, frames)):
        r = m.estimate_ground(scan)
        label = f"{engine} frame {k}"
        np.testing.assert_array_equal(r.ground_mask, want["labels"], err_msg=label)
        _assert_planes(r.centers, r.normals, want["centers"], want["normals"], label)
        _assert_state(m, want, label)
        nan += int(np.isnan(r.normals).any(axis=1).sum())
    assert nan > 0  # the one-point fits and their chains were exercised


def test_leading_empty_patches_take_the_previous_scans_plane(chain):
    """A scan whose first ring holds no point: its 16 empty patches take the
    plane the state carried in, the previous scan's last processed
    patch's (here an upright ground plane, which zone 0's A-GLE accepts),
    as the oracle (one object across scans) does."""
    scans, _ = chain
    p = ros_launch_params()
    o = NumpyPatchworkpp(p)
    scans = [_with_ground_in_last_patch(scans[0]), scans[1]]
    first = _oracle_frame(o, scans[0])
    ids, _ = o._czm_assign(scans[1], np.zeros(len(scans[1]), bool))
    second = scans[1][~((ids >= 0) & (ids < ZONE0_RING0))]
    want = _oracle_frame(o, second)
    assert want["empty"] >= ZONE0_RING0

    m = PatchworkPP(p, capacity=CAP, device="cpu")
    a = m.estimate_ground(scans[0])
    carried = m.state.plane.numpy()
    assert carried[5] > p.uprightness_thr  # the last patch's upright plane
    np.testing.assert_array_equal(carried[:3], a.centers[-1])
    np.testing.assert_array_equal(carried[3:6], a.normals[-1])
    np.testing.assert_allclose(carried, first["plane"], rtol=0, atol=NORMAL_ATOL)
    b = m.estimate_ground(second)
    for s in range(ZONE0_RING0):
        np.testing.assert_array_equal(b.centers[s], carried[:3], err_msg=f"patch {s}")
        np.testing.assert_array_equal(b.normals[s], carried[3:6], err_msg=f"patch {s}")
    np.testing.assert_array_equal(b.ground_mask, want["labels"])
    _assert_planes(b.centers, b.normals, want["centers"], want["normals"], "second")
    _assert_state(m, want, "second")


def _with_ground_in_last_patch(cloud: np.ndarray) -> np.ndarray:
    """``cloud`` with 40 points of a level ground 1.88 m down added to the
    last patch in flat order (zone 3's outer ring, its last sector), so
    that the scan ends on an upright plane."""
    rng = np.random.default_rng(7)
    r = rng.uniform(76.0, 79.0, 40)
    th = 2 * np.pi * (31.5 + rng.uniform(-0.3, 0.3, 40)) / 32
    z = -1.88 + rng.normal(0.0, 0.01, 40)
    pts = np.stack([r * np.cos(th), r * np.sin(th), z, np.full(40, 0.5)], axis=1)
    return np.concatenate([cloud, pts.astype(np.float32)])


def _npz(state: dict) -> io.BytesIO:
    buf = io.BytesIO()
    np.savez(buf, **state)
    buf.seek(0)
    return buf


def test_checkpoint_round_trip_keeps_the_plane(chain, tmp_path):
    scans, _ = chain
    p = ros_launch_params()
    m = PatchworkPP(p, capacity=CAP, device="cpu")
    m.estimate_ground(scans[0])
    path = str(tmp_path / "state.npz")
    m.save_state(path)
    with np.load(path) as d:
        assert d["plane"].shape == (PLANE_WIDTH,) and d["plane"].dtype == np.float32
        np.testing.assert_array_equal(d["plane"], m.state.plane.numpy())
    restored = PatchworkPP(p, capacity=CAP, device="cpu")
    restored.load_state(path)
    np.testing.assert_array_equal(restored.state.plane.numpy(), m.state.plane.numpy())
    for scan in scans[1:]:
        want, got = m.estimate_ground(scan), restored.estimate_ground(scan)
        np.testing.assert_array_equal(got.ground_mask, want.ground_mask)
        np.testing.assert_array_equal(got.centers, want.centers)
        np.testing.assert_array_equal(got.normals, want.normals)
    for k, v in m.state.to_numpy().items():
        np.testing.assert_array_equal(restored.state.to_numpy()[k], v, err_msg=k)


def test_checkpoint_without_the_plane_loads_the_zero_plane(chain):
    """A checkpoint without ``plane`` (the JAX package's keys) carries the
    zero plane of a fresh state: a scan whose first ring is empty then
    reports zero planes there."""
    scans, _ = chain
    p = ros_launch_params()
    m = PatchworkPP(p, capacity=CAP, device="cpu")
    m.estimate_ground(scans[0])
    state = m.state.to_numpy()
    assert np.any(state["plane"] != 0)
    del state["plane"]
    m.load_state(_npz(state))
    np.testing.assert_array_equal(m.state.plane.numpy(), np.zeros(PLANE_WIDTH, np.float32))
    ids, _ = NumpyPatchworkpp(p)._czm_assign(scans[1], np.zeros(len(scans[1]), bool))
    r = m.estimate_ground(scans[1][~((ids >= 0) & (ids < ZONE0_RING0))])
    np.testing.assert_array_equal(r.centers[:ZONE0_RING0], 0.0)
    np.testing.assert_array_equal(r.normals[:ZONE0_RING0], 0.0)


def _inherited() -> int:
    return profiling.counters().get("frame.inherited_planes", profiling.Count(0, 0.0)).n


def test_inherited_planes_counter_counts_empty_processed_patches(chain):
    """``frame.inherited_planes`` adds each scan's empty processed patches
    (the oracle's count), through ``estimate_ground`` and
    ``estimate_ground_sequence`` alike; a profile with ``num_min_pts`` >= 1
    builds no carry and adds nothing."""
    scans, frames = chain
    want = sum(f["empty"] for f in frames)
    assert want > 200 * FRAMES
    m = PatchworkPP(ros_launch_params(), capacity=CAP, device="cpu")
    before = _inherited()
    loop = [m.estimate_ground(s) for s in scans]
    assert _inherited() - before == want
    m.reset()
    before = _inherited()
    seq = m.estimate_ground_sequence(scans)
    assert _inherited() - before == want
    for a, b in zip(seq, loop):
        np.testing.assert_array_equal(a.ground_mask, b.ground_mask)
        np.testing.assert_array_equal(a.normals, b.normals)

    d = PatchworkPP(Params(), capacity=CAP, device="cpu")
    before = _inherited()
    d.estimate_ground_sequence(scans)
    d.estimate_ground(scans[0])
    assert _inherited() == before
    assert next(iter(d._frames.values())).inherited_planes is None
    np.testing.assert_array_equal(d.state.plane.numpy(), np.zeros(PLANE_WIDTH, np.float32))


@pytest.mark.gpu
def test_card_sequence_and_server_equal_the_cpu_path():
    """On the card, the captured facade's sequence path and the server
    (batch_max 1) under the launch profile give the CPU path's labels,
    planes and state, bit for bit, on full-width scans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from patchworkpp_tpu_torch.serve import CloudMsg, GroundSegmentationServer, ServerConfig

    p = ros_launch_params()
    scans = [make_scan(3, f) for f in range(6)]
    cpu = PatchworkPP(p, capacity=131072, device="cpu")
    want = [cpu.estimate_ground(s) for s in scans]
    card = PatchworkPP(p, capacity=131072)
    card.estimate_ground_sequence(scans[:2])  # captures the frame
    card.reset()
    before = _inherited()
    got = card.estimate_ground_sequence(scans)
    assert _inherited() - before > 100 * len(scans)
    answers, answered = [], threading.Event()
    srv = GroundSegmentationServer(p, ServerConfig(capacity=131072, batch_max=1),
                                   device="cuda")
    srv.on_result(lambda msg: (answers.append(msg), answered.set()))
    srv.start()
    try:
        for i, s in enumerate(scans):  # closed loop: each scan once the last answered
            answered.clear()
            srv.publish(CloudMsg(points=s, stamp=float(i)))
            assert answered.wait(120), f"scan {i} not answered"
    finally:
        srv.stop()
    assert [a.error for a in answers] == [None] * len(scans)
    for k, w in enumerate(want):
        for name, r in (("sequence", got[k]), ("server", answers[k].result)):
            for f in ("ground_mask", "centers", "normals"):
                np.testing.assert_array_equal(getattr(r, f), getattr(w, f),
                                              err_msg=f"{name} scan {k} {f}")
    for k, v in cpu.state.to_numpy().items():
        np.testing.assert_array_equal(card.state.to_numpy()[k], v, err_msg=k)
