"""The plain reference against the port's CPU path, and the drive
generator, at sub-sampled sizes on the CPU."""

import numpy as np
import pytest

from benchmark import manifest as mf
from benchmark.check import _plane_bad, buffer_gap, state_gaps
from benchmark.reference.oracle import Reference, bf16
from benchmark.reference.params import Params as RefParams
from benchmark.scans import make_drive, make_scan

CONFIGS = ["kitti_hdl64"]


def _config(root, name):
    return mf.config(mf.load_manifest(root), root, name)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_ports_cpu_path_over_a_short_chain(root, name):
    torch = pytest.importorskip("torch")  # noqa: F841
    from benchmark.system import Port

    cfg = _config(root, name)
    cfg["capacity"] = 40960
    port = Port(cfg, "cpu").facade()
    ref = Reference(RefParams.from_overrides(cfg["params"]))
    for scan in make_drive(3, 3, cfg["sensor"], sub=4):
        got = port.estimate_ground(scan)
        want = ref.estimate_ground(scan)
        assert (got.ground_mask != want).mean() <= 1e-4
        bad, total = _plane_bad(got.centers, got.normals, ref.centers, ref.normals)
        assert total > 100 and bad <= 0.02 * total
        gaps = state_gaps(port.state.to_numpy(), ref.export_state())
        assert gaps["height_gap"] <= 1e-5 and gaps["flatness_gap"] <= 1e-3
        assert buffer_gap(port.state.to_numpy(), ref.export_state()) <= 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_carries_its_own_state(root, name):
    cfg = _config(root, name)
    params = RefParams.from_overrides(cfg["params"])
    ref = Reference(params)
    for scan in make_drive(5, 2, cfg["sensor"], sub=8):
        ref.estimate_ground(scan)
    assert ref.sensor_height != params.sensor_height
    moved = Reference(params)
    moved.import_state(ref.export_state())
    assert buffer_gap(moved.export_state(), ref.export_state()) == 0.0
    scan = make_scan(5, 2, cfg["sensor"])[::8]
    np.testing.assert_array_equal(moved.estimate_ground(scan), ref.estimate_ground(scan))
    assert max(state_gaps(moved.export_state(), ref.export_state()).values()) < 1e-6
    assert buffer_gap(moved.export_state(), ref.export_state()) == 0.0


def _buffers(rings):
    """The checkpoint layout of four rings' sample lists, twice over."""
    buf = np.zeros((4, 1064), np.float32)
    for i, b in enumerate(rings):
        buf[i, : len(b)] = b
    cnt = np.array([len(b) for b in rings], np.int32)
    return {"elev_buf": buf, "elev_cnt": cnt, "flat_buf": buf * 1e-3, "flat_cnt": cnt}


def test_the_buffer_gap_takes_entries_in_place_and_by_the_median():
    rng = np.random.default_rng(4)
    rings = [list(-1.7 + 0.05 * rng.standard_normal(40)) for _ in range(4)]
    want = _buffers(rings)
    assert buffer_gap(_buffers(rings), want) == 0.0
    # one ring's entries a part in a thousand off: a quarter of the entries
    moved = [[v * (1 + 1e-3) for v in rings[0]]] + rings[1:]
    assert buffer_gap(_buffers(moved), want) == 0.0
    # every entry a part in a thousand off, or the entries out of order
    assert 2e-4 < buffer_gap(_buffers([[v * (1 + 1e-3) for v in b] for b in rings]), want)
    assert buffer_gap(_buffers([b[::-1] for b in rings]), want) > 1e-3
    # one more sample at the end of one ring: one entry of 320 lacks a partner
    assert buffer_gap(_buffers([rings[0] + [-1.6]] + rings[1:]), want) == 0.0
    # empty buffers where the reference has samples, or no state at all
    assert buffer_gap(_buffers([[], [], [], []]), want) == np.inf
    assert buffer_gap(None, want) == np.inf


@pytest.mark.parametrize("name", CONFIGS)
def test_the_generator_is_deterministic_and_sized(root, name):
    sensor = _config(root, name)["sensor"]
    a = make_scan(2**31 + 7, 4, sensor)
    np.testing.assert_array_equal(a, make_scan(2**31 + 7, 4, sensor))
    assert a.shape == (sensor["points"], 4) and a.dtype == np.float32
    assert not np.array_equal(a, make_scan(2**31 + 7, 5, sensor))
    assert not np.array_equal(a, make_scan(2**31 + 8, 4, sensor))


def test_the_64_beam_scans_begin_with_the_ports_generator(root):
    synthetic = pytest.importorskip("patchworkpp_tpu_torch.io.synthetic")
    sensor = dict(_config(root, "kitti_hdl64")["sensor"], points=130048)
    for seed, frame in ((0, 0), (9, 3)):
        port = synthetic.make_scan(seed, frame)
        np.testing.assert_array_equal(make_scan(seed, frame, sensor)[: len(port)], port)


def test_bf16_rounds_as_torch_does():
    torch = pytest.importorskip("torch")
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 10, 10000), [1.00390625, 1.005859375, -2.5, 3e38]])
    x = x.astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16(x), want)
    assert np.isinf(bf16(np.float32(np.inf))) and np.isnan(bf16(np.float32(np.nan)))
