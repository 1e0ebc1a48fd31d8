"""The port's CLIs and data layer on the CPU at tiny sizes: the bench's timed
loop and JSON line, soak, stream_bench, serve_bench and the two demos end to
end with ``--device cpu`` (their six-scan cycle replaced by two small seeded
clouds of tests/test_fuzz_parity.py:synth_cloud at capacity 8192), the
workload's scan source, and ``io/kitti.py`` against the JAX package's on
temporary files. The CLIs print timings of a CPU run; nothing here reads
them as device numbers.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import patchworkpp_tpu.io.kitti as j_kitti
import patchworkpp_tpu_torch.io.kitti as kitti
from patchworkpp_tpu_torch.cli import (
    bench,
    demo_multi_stream,
    demo_sequential,
    serve_bench,
    soak,
    stream_bench,
    workload,
)
from patchworkpp_tpu_torch.io.synthetic import make_scan
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import _one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--capacity", str(CAP)]


@pytest.fixture()
def two_scans(monkeypatch):
    """Every CLI's scan cycle becomes two small clouds."""
    scans = [synth_cloud(s, exact_edges=False) for s in (0, 1)]
    monkeypatch.delenv(workload.DATA_ENV, raising=False)
    for mod in (bench, soak, stream_bench, serve_bench, demo_sequential):
        monkeypatch.setattr(mod, "scan_cycle", lambda seed=0, sub=1: ("synth6", scans))
    return scans


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_bench_prints_one_json_line(two_scans, capsys):
    assert bench.main(SMALL + ["--repeat", "1", "--epochs", "4", "--groups", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "synth6_seq_scans_per_s" and line["unit"] == "scans/s"
    assert line["groups"] == 2 and line["frames_total"] == 8
    assert line["frames_per_dispatch"] == 2 and line["vs_baseline"] is None
    assert line["min"] <= line["value"] <= line["max"] and line["mean"] > 0
    assert line["device"] == "cpu" and line["card"] is None


def test_bench_streams_frame_dispatch(two_scans, capsys, monkeypatch):
    monkeypatch.setattr(bench, "WARMUP_DISPATCHES", 1)
    assert bench.main(SMALL + ["--streams", "2", "--dispatch", "frame", "--epochs", "2",
                               "--groups", "1", "--fused", "tiled"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "synth6_tiled_streams2_frame_agg_scans_per_s"
    assert line["streams"] == 2 and line["frames_per_dispatch"] == 1
    assert line["frames_total"] == 4


def test_bench_timed_groups_split_and_sync():
    calls = {"step": 0, "sync": 0}

    def step():
        calls["step"] += 1

    def sync():
        calls["sync"] += 1
        return 0.0

    rates, frames, dt = bench.timed_groups(step, sync, dispatches=7, groups=3,
                                           frames_per_dispatch=24)
    assert calls == {"step": 7, "sync": 3}
    assert len(rates) == 3 and frames == 7 * 24 and dt > 0
    rates, frames, _ = bench.timed_groups(step, sync, dispatches=2, groups=5,
                                          frames_per_dispatch=6)
    assert len(rates) == 2 and frames == 12


def test_bench_refuses_chunks_and_names_metrics():
    """--chunks is refused outside the single-stream epoch run and on a
    capacity it does not divide, as in the JAX bench, and names the metric
    ``_c{K}``."""
    with pytest.raises(SystemExit, match="single-stream"):
        bench.main(["--chunks", "2", "--streams", "2"])
    with pytest.raises(SystemExit, match="single-stream"):
        bench.main(["--chunks", "2", "--dispatch", "frame"])
    with pytest.raises(SystemExit, match="not divisible"):
        bench.main(["--chunks", "3", "--capacity", "8192"])
    args = bench.parse_args(["--densify", "2", "--fused", "onehot"])
    assert bench._name(args, "kitti6") == "kitti6_x2_onehot"
    assert bench._name(bench.parse_args(["--chunks", "2"]), "synth6") == "synth6_c2"
    assert bench._vs_baseline(bench.parse_args([]), "kitti6", 59.6) == pytest.approx(2.0)
    assert bench._vs_baseline(bench.parse_args([]), "synth6", 59.6) is None
    stack, npts = bench.build_stack([np.ones((5, 3), np.float32)], 2, 16)
    assert stack.shape == (1, 16, 4) and list(npts) == [10]
    with pytest.raises(SystemExit, match="capacity"):
        bench.build_stack([np.ones((20, 4), np.float32)], 1, 16)


def test_soak_end_to_end(two_scans, capsys):
    rc = soak.main(SMALL + ["--repeat", "1", "--frames", "4", "--groups", "2"])
    rec = _json_lines(capsys.readouterr().out)[-1]
    assert rec["frames"] == 4 and len(rec["scans_per_s_groups"]) == 2
    # a CPU run's group rates are noisy; every other check must pass
    assert [f for f in rec["failures"] if "throughput" not in f] == []
    assert rc == (0 if rec["ok"] else 1)
    assert 1.0 < rec["sensor_height_last"] < 2.5
    assert all(0 < c <= 1000 for c in rec["elev_cnt"][:3])


def test_soak_rate_check():
    assert soak.rate_failures([10.0, 10.0, 9.0, 8.0]) == []
    assert soak.rate_failures([10.0, 9.0, 8.0, 7.0]) == ["throughput decayed 10.0 -> 7.0 scans/s"]


def test_stream_bench_end_to_end(two_scans, capsys):
    assert stream_bench.main(SMALL + ["--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "synth6: 2 frames in" in out and "scans/s" in out and "on cpu" in out


def test_serve_bench_end_to_end(two_scans, capsys):
    assert serve_bench.main(SMALL + ["--frames", "3", "--overload", "2.0"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [r.get("mode") for r in lines[:3]] == [
        "closed_loop_batch1", "overload_batch1", "overload_batch6"]
    assert lines[0]["frames"] == 1 and lines[0]["p50_ms"] > 0
    for r in lines[1:3]:
        assert r["frames_processed"] + r["dropped"] == 3
    assert lines[-1]["metric"] == "synth6_serve_bench" and lines[-1]["service_rate_hz"] > 0
    with pytest.raises(SystemExit, match="--frames >= 3"):
        serve_bench.closed_loop([], 2, "cpu", CAP)


def test_demo_sequential_text_path(two_scans, capsys, tmp_path):
    assert demo_sequential.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("synthetic 0:") and "ground /" in out[0]
    for i, s in enumerate(two_scans):  # a directory of .bin scans
        s.astype(np.float32).tofile(tmp_path / f"{i:06d}.bin")
    assert demo_sequential.main([str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["000000.bin", "000001.bin"]


def test_demo_multi_stream_text_path(two_scans, capsys):
    assert demo_multi_stream.main(SMALL + ["--streams", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[1].startswith("step 0 stream1 (synthetic 1)")


def test_workload_scan_source(monkeypatch, tmp_path):
    monkeypatch.delenv(workload.DATA_ENV, raising=False)
    name, scans = workload.scan_cycle(seed=0, sub=64)
    assert name == "synth6" and len(scans) == 6
    np.testing.assert_array_equal(scans[1], make_scan(0, 1)[::64])
    rng = np.random.default_rng(0)
    kitti_scans = [rng.normal(size=(50 + i, 4)).astype(np.float32) for i in range(6)]
    for i, s in enumerate(kitti_scans):
        s.tofile(tmp_path / f"{i:06d}.bin")
    monkeypatch.setenv(workload.DATA_ENV, str(tmp_path))
    name, scans = workload.scan_cycle(sub=2)
    assert name == "kitti6"
    for a, b in zip(scans, kitti_scans):
        np.testing.assert_array_equal(a, b[::2])
    os.remove(tmp_path / "000005.bin")
    with pytest.raises(FileNotFoundError, match="000005"):
        workload.scan_cycle()
    assert workload.card(workload.resolve_device("cpu")) is None


def test_cuda_is_the_default_and_refused_without_it(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        workload.resolve_device("cuda")


def test_kitti_io_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    scan = rng.normal(size=(37, 4)).astype(np.float32)
    labels = rng.choice([40, 44, 48, 49, 60, 72, 10, 50, 70], 37).astype(np.uint32)
    labels |= rng.integers(0, 5, 37).astype(np.uint32) << 16
    for root in ("flat", os.path.join("sk", "sequences", "04")):
        d = tmp_path / root
        (d / "velodyne" if root != "flat" else d).mkdir(parents=True)
    (tmp_path / "sk" / "sequences" / "04" / "labels").mkdir()
    for path in (tmp_path / "flat" / "000000.bin",
                 tmp_path / "sk" / "sequences" / "04" / "velodyne" / "000000.bin"):
        scan.tofile(path)
    label_path = tmp_path / "sk" / "sequences" / "04" / "labels" / "000000.label"
    labels.tofile(label_path)

    np.testing.assert_array_equal(kitti.read_bin(str(tmp_path / "flat" / "000000.bin")),
                                  j_kitti.read_bin(str(tmp_path / "flat" / "000000.bin")))
    lab = kitti.read_labels(str(label_path))
    np.testing.assert_array_equal(lab, j_kitti.read_labels(str(label_path)))
    gt = kitti.ground_truth_mask(lab)
    np.testing.assert_array_equal(gt, j_kitti.ground_truth_mask(lab))
    assert kitti.GROUND_LABELS == j_kitti.GROUND_LABELS
    for cap in (37, 64):
        a, b = kitti.pad_cloud(scan[:, :3], cap), j_kitti.pad_cloud(scan[:, :3], cap)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] == 37
    with pytest.raises(ValueError):
        kitti.pad_cloud(scan, 36)
    pred = rng.uniform(size=37) < 0.5
    assert tuple(kitti.evaluate_masks(pred, gt)) == tuple(j_kitti.evaluate_masks(pred, gt))

    flat, jflat = kitti.ScanDataset(str(tmp_path / "flat")), j_kitti.ScanDataset(
        str(tmp_path / "flat"))
    assert flat.names == jflat.names and len(flat) == 1 and flat.labels(0) is None
    sk = kitti.ScanDataset.semantickitti(str(tmp_path / "sk"), "04")
    jsk = j_kitti.ScanDataset.semantickitti(str(tmp_path / "sk"), "04")
    (s0, l0), (js0, jl0) = next(iter(sk)), next(iter(jsk))
    np.testing.assert_array_equal(s0, js0)
    np.testing.assert_array_equal(l0, jl0)
    with pytest.raises(FileNotFoundError):
        kitti.ScanDataset(str(tmp_path / "sk"))
