"""The frame tail's label replay (ops/label_replay_kernel.py): the kernel KL
on the card and its plain version on the CPU.

On the CPU:

- the plain version equals, bit for bit (mask and count), a literal copy of
  the replay the frame ran inline before KL, at several row-block sizes
  (``pipeline._REPLAY_BLOCK``) and snapshot counts, on seeded tables that
  hold the replay's hazards: NaN one-point planes, sentinel-gated
  snapshots, codes 0-3, padding rows in the overflow bucket, points on
  both sides of every threshold;
- the wrapper sends a CPU tensor to the plain version without counting,
  and its checks raise on a dtype, shape or device the kernel does not take;
- the ``extern "C"`` entries have the argtypes the wrapper declares.

On the card (``gpu``; they skip without CUDA): KL equals the plain version
bit for bit on the same tables (also (P, 3) clouds, unaligned rows, row
counts that are not a multiple of the block, a real frame's inputs); the
captured tiled frame equals the CPU frame over chained frames, at
``Params()`` and at the ROS 2 launch profile (labels, ``num_ground``, the
whole state); KL's launch count on the card equals the replays.

This file imports no JAX, so that it runs on a machine with the card and
without JAX, past tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_label_replay.py
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu_torch.pipeline as tpipe  # noqa: E402
from patchworkpp_tpu_torch import Params, PatchworkPP  # noqa: E402
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_scan  # noqa: E402
from patchworkpp_tpu_torch.models.presets import ros_launch_params  # noqa: E402
from patchworkpp_tpu_torch.ops import f32, plane_dist  # noqa: E402
from patchworkpp_tpu_torch.ops import label_replay_kernel as kl  # noqa: E402

SPAD = 512
SENTINEL = [0.0, 0.0, 0.0, f32(1e30)]
TH_DIST, TH_DIST_V = f32(0.125), f32(0.1)  # Params()'s th_dist and th_dist_v


def _former_replay(label_tab, n_snaps, pid_o, x_o, y_o, z_o, th_dist, th_dist_v, blk):
    """A literal copy of pipeline._finalize's inline replay before KL (its
    ``len(vpf_tables)`` is ``n_snaps``, ``f32(p.th_dist)`` and
    ``f32(p.th_dist_v)`` the two thresholds, ``dev`` the tensors'),
    returning the mask and the count the frame took from it."""
    dev = pid_o.device

    def _replay(pid_b, xb, yb, zb):
        # a gather (the JAX package's one-hot MXU lookup, ops/onehot.py,
        # returns the same bits)
        lk = label_tab[pid_b]

        def _plane_dist(c0):
            return plane_dist(xb, yb, zb, lk[:, c0], lk[:, c0 + 1],
                              lk[:, c0 + 2], lk[:, c0 + 3])

        dist_o = _plane_dist(0)
        peeled = torch.zeros(pid_b.shape[0], dtype=torch.bool, device=dev)
        for it in range(n_snaps):
            peeled = peeled | (
                torch.abs(_plane_dist(5 + 4 * it)) < th_dist_v
            )
        return (
            (lk[:, 4] > 1.5)
            & ~peeled
            & (dist_o < th_dist)
            & (lk[:, 4] > 2.5)
        )

    pid_l = pid_o.to(torch.int64)
    ground = torch.cat([
        _replay(pid_l[s:s + blk], x_o[s:s + blk], y_o[s:s + blk], z_o[s:s + blk])
        for s in range(0, pid_l.shape[0], blk)
    ])
    return ground, torch.sum(ground).to(torch.int32)


def _plane(rng, n):
    """(n, 4) planes [nx, ny, nz, d]: near-upright unit normals, some
    vertical, offsets of a metre or two."""
    nrm = rng.normal(size=(n, 3)) * np.array([0.2, 0.2, 1.0])
    nrm[rng.random(n) < 0.2, 2] *= 0.05  # vertical walls, for the peel tests
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([nrm, rng.uniform(-2.0, 2.0, (n, 1))], axis=1)


def _tables(seed, rows, n_snaps, cols=4):
    """Seeded replay inputs: (points (rows, cols), patch_id (rows,) int32,
    label_tab (SPAD, 5 + 4 n_snaps)).

    Patch ids run in spatially coherent runs, the last 5% of the rows are
    padding (zeros, the overflow bucket SPAD - 1 with code 0); codes 0-3;
    a tenth of the patches hold a one-point fit's NaN plane, a third of the
    snapshots the sentinel plane of a shut gate; each point's height puts
    its distance from its final plane, and from one of its snapshot planes,
    within a few thresholds of 0, so both sides of each test occur."""
    rng = np.random.default_rng(seed)
    final = _plane(rng, SPAD)
    final[rng.random(SPAD) < 0.1, :] = np.nan
    code = rng.integers(0, 4, SPAD).astype(np.float64)
    code[SPAD - 1] = 0.0
    snaps = []
    for _ in range(n_snaps):
        s = _plane(rng, SPAD)
        s[rng.random(SPAD) < 0.33] = SENTINEL
        s[rng.random(SPAD) < 0.05, :] = np.nan
        snaps.append(s)
    tab = np.concatenate([final, code[:, None]] + snaps, axis=1).astype(np.float32)

    real = rows - rows // 20
    starts = np.sort(rng.integers(0, max(real, 1), 40))
    pid = np.zeros(rows, np.int32)
    pid[:real] = rng.integers(0, SPAD - 1, 41)[np.searchsorted(starts, np.arange(real))]
    pid[real:] = SPAD - 1
    flip = rng.random(real) < 0.05  # scattered points of other patches
    pid[:real][flip] = rng.integers(0, SPAD, int(flip.sum()))
    xy = rng.uniform(-40.0, 40.0, (rows, 2))
    # a plane to sit near: the final one, or (a third of the points) a snapshot
    near = final[pid].copy()
    if n_snaps:
        which = rng.integers(0, n_snaps, rows)
        use = (rng.random(rows) < 0.33) & np.isfinite(snaps[0][pid, 0])
        near[use] = np.stack(snaps)[which, pid][use]
    nz = np.where(np.abs(near[:, 2]) > 0.05, near[:, 2], 1.0)
    z = -(near[:, 0] * xy[:, 0] + near[:, 1] * xy[:, 1] + near[:, 3]) / nz
    z = np.nan_to_num(z, nan=0.0) + rng.uniform(-0.4, 0.4, rows)
    pts = np.zeros((rows, cols), np.float32)
    pts[:real, 0:2] = xy[:real]
    pts[:real, 2] = np.clip(z[:real], -50.0, 50.0)
    if cols > 3:
        pts[:real, 3] = rng.random(real)
    return torch.from_numpy(pts), torch.from_numpy(pid), torch.from_numpy(tab)


def _former(pts, pid, tab, blk, th=(TH_DIST, TH_DIST_V)):
    return _former_replay(tab, kl.snapshots(tab), pid, pts[:, 0], pts[:, 1], pts[:, 2],
                          th[0], th[1], blk)


def _assert_same(got, want, label):
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32, label
    assert got[1].shape == (), label
    assert torch.equal(got[0].cpu(), want[0].cpu()), (
        f"{label}: {int((got[0].cpu() != want[0].cpu()).sum())} labels differ")
    assert int(got[1]) == int(want[1]) == int(want[0].sum()), label


# ---- the CPU: the plain version, the wrapper's dispatch and checks


@pytest.mark.parametrize("n_snaps", [0, 1, 3])
@pytest.mark.parametrize("blk", [65536, 1000, 333])
def test_plain_version_equals_former_inline_replay(monkeypatch, blk, n_snaps):
    pts, pid, tab = _tables(blk + n_snaps, 5000, n_snaps)
    want = _former(pts, pid, tab, blk)
    assert 0 < int(want[1]) < len(pid)  # both labels occur
    monkeypatch.setattr(tpipe, "_REPLAY_BLOCK", blk)
    _assert_same(kl.label_replay_reference(pts, pid, tab, TH_DIST, TH_DIST_V), want,
                 f"blk {blk}, {n_snaps} snapshots")


def test_plain_version_equals_former_replay_on_a_frame(monkeypatch):
    """The inputs the CPU frame hands the replay (make_scan's scan cut to
    ~4k points, capacity 8192), at two block sizes; the frame's labels
    and count are the replay's."""
    calls = []

    def record(*args):
        calls.append(args)
        return kl.label_replay(*args)

    monkeypatch.setattr(tpipe, "label_replay", record)
    scan = make_scan(3, 0)[::30]
    m = PatchworkPP(capacity=8192, device="cpu")
    res = m.estimate_ground(scan)
    (pts, pid, tab, th, thv), = calls
    assert tab.shape == (SPAD, 5 + 4 * Params().num_iter) and th == TH_DIST and thv == TH_DIST_V
    for blk in (65536, 1024):
        monkeypatch.setattr(tpipe, "_REPLAY_BLOCK", blk)
        got = kl.label_replay_reference(pts, pid, tab, th, thv)
        _assert_same(got, _former(pts, pid, tab, blk), f"frame, blk {blk}")
        np.testing.assert_array_equal(got[0][: len(scan)].numpy(), res.ground_mask)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    pts, pid, tab = _tables(7, 3000, 3)
    before = kl.label_replay.launches
    _assert_same(kl.label_replay(pts, pid, tab, TH_DIST, TH_DIST_V),
                 kl.label_replay_reference(pts, pid, tab, TH_DIST, TH_DIST_V), "wrapper")
    assert kl.label_replay.launches == before


def _bad(case):
    pts, pid, tab = _tables(11, 600, 2)
    return {
        "points f64": (pts.double(), pid, tab),
        "points (P, 2)": (pts[:, :2].contiguous(), pid, tab),
        "points strided columns": (pts.t().contiguous().t(), pid, tab),
        "patch_id int64": (pts, pid.long(), tab),
        "patch_id short": (pts, pid[:-1], tab),
        "label_tab f64": (pts, pid, tab.double()),
        "label_tab 6 columns": (pts, pid, tab[:, :6].contiguous()),
        "label_tab no rows": (pts, pid, tab[:0]),
        "patch_id on another device": (pts, pid.to("meta"), tab),
        "points on meta": (pts.to("meta"), pid.to("meta"), tab.to("meta")),
    }[case]


@pytest.mark.parametrize("case", [
    "points f64", "points (P, 2)", "points strided columns", "patch_id int64", "patch_id short",
    "label_tab f64", "label_tab 6 columns", "label_tab no rows", "patch_id on another device",
    "points on meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    before = kl.label_replay.launches
    with pytest.raises(ValueError, match="points|patch_id|label_tab|CUDA tensors"):
        kl.label_replay(*_bad(case), TH_DIST, TH_DIST_V)
    assert kl.label_replay.launches == before


def _extern_c_argtypes(symbol):
    """ctypes types of the ``extern "C"`` entry ``symbol``'s parameters."""
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', kl.SOURCE.read_text())
    assert m, symbol
    rule = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if p.strip().rsplit(" ", 1)[0].endswith("*")
            else rule[p.strip().rsplit(" ", 1)[0].replace("const ", "")]
            for p in m.group(1).split(",")]


def test_argtypes_follow_extern_c_signatures():
    assert list(kl.ARGTYPES) == _extern_c_argtypes("ppk_label_replay")
    assert list(kl.LAUNCH_ARGTYPES) == _extern_c_argtypes("ppk_label_replay_launches")


# ---- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "131072 rows, 3 snapshots", "131035 rows, 3 snapshots", "1 row", "255 rows", "257 rows",
    "0 snapshots", "1 snapshot", "2 snapshots", "4 snapshots", "(P, 3) cloud", "unaligned rows"])
def test_kernel_equals_plain_version_on_card(case):
    dev = _card()
    rows = {"131035 rows, 3 snapshots": 131035, "1 row": 1, "255 rows": 255,
            "257 rows": 257}.get(case, CAPACITY)
    n_snaps = {"0 snapshots": 0, "1 snapshot": 1, "2 snapshots": 2, "4 snapshots": 4}.get(case, 3)
    pts, pid, tab = _tables(rows + n_snaps, rows, n_snaps, cols=3 if "(P, 3)" in case else 4)
    want = kl.label_replay_reference(pts, pid, tab, TH_DIST, TH_DIST_V)
    before = kl.label_replay.launches
    d = [t.to(dev) for t in (pts, pid, tab)]
    if case == "unaligned rows":  # 4 bytes into a buffer: no 16-byte row loads
        d[0] = torch.cat([torch.zeros(1, device=dev), d[0].flatten()])[1:].view(-1, 4)
        assert d[0].data_ptr() % 16 == 4
    got = kl.label_replay(*d, TH_DIST, TH_DIST_V)
    torch.cuda.synchronize()
    assert kl.label_replay.launches == before + 1
    _assert_same(got, want, f"{case}: KL vs plain (cpu)")
    _assert_same(got, kl.label_replay_reference(*d, TH_DIST, TH_DIST_V),
                 f"{case}: KL vs plain (card)")


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_a_frames_inputs():
    """The inputs of a captured-size frame (make_scan(0, 0), capacity
    131072, recorded from the CPU frame), on the card and on the CPU."""
    dev = _card()
    calls = []

    def record(*args):
        calls.append(args)
        return kl.label_replay(*args)

    saved = tpipe.label_replay
    tpipe.label_replay = record
    try:
        PatchworkPP(capacity=CAPACITY, device="cpu").estimate_ground(make_scan(0, 0))
    finally:
        tpipe.label_replay = saved
    (pts, pid, tab, th, thv), = calls
    got = kl.label_replay(pts.to(dev), pid.to(dev), tab.to(dev), th, thv)
    _assert_same(got, kl.label_replay_reference(pts, pid, tab, th, thv), "frame inputs")


FRAMES = 4


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["Params()", "ros_launch_params()"])
def test_captured_frame_equals_cpu_frame_on_card(preset):
    """FRAMES chained frames of make_scan(0, k): the captured tiled frame on
    the card (its replay KL) against the CPU frame (the plain replay):
    labels, num_ground and the state after each frame, bit for bit; KL
    launched once a replay, counted by the wrapper and on the card."""
    _card()
    p = Params() if preset == "Params()" else ros_launch_params()
    scans = [make_scan(0, k) for k in range(FRAMES)]
    gpu = PatchworkPP(p, capacity=CAPACITY)
    gpu.estimate_ground(scans[0])  # builds the kernels, captures the frame
    gpu.reset()
    cpu = PatchworkPP(p, capacity=CAPACITY, device="cpu")
    kl.label_replay.launches = 0
    kl.kernel_launches(reset=True)
    for k, scan in enumerate(scans):
        got, want = gpu.estimate_ground(scan), cpu.estimate_ground(scan)
        np.testing.assert_array_equal(got.ground_mask, want.ground_mask, err_msg=f"frame {k}")
        assert int(gpu.last_result.num_ground) == int(cpu.last_result.num_ground) \
            == int(want.ground_mask.sum()), f"frame {k}"
        for name, v in cpu.state.to_numpy().items():
            g = gpu.state.to_numpy()[name]
            assert g.tobytes() == v.tobytes(), f"frame {k}: state {name} differs"
    assert kl.label_replay.launches == FRAMES
    assert kl.kernel_launches() == FRAMES
