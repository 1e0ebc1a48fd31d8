"""The port's eval and demo CLIs against the JAX package's, on the CPU.

``cli/eval_semantickitti.py`` on the two-frame SemanticKITTI tree of
tests/test_eval_gt.py (its ``kitti_root`` fixture, built from its
``_scene``): the ``--json`` line's precision, recall, F1 and accuracy equal
the JAX CLI's at ``--batch 1`` and ``--batch 2``; with ``--golden`` on the
synthetic golden npz of tests/test_torch_golden.py, precision = recall =
F1 = 1. ``cli/demo_visualize.py`` on a synthetic ``.bin``: the printed
ground and non-ground counts equal the JAX demo's, and ``--save`` writes
the PNG. The CLIs print timings of a CPU run; nothing here reads them.
"""

from __future__ import annotations

import json
import sys

import pytest

pytest.importorskip("torch")

from patchworkpp_tpu.cli import demo_visualize as j_demo
from patchworkpp_tpu.cli import eval_semantickitti as j_eval
from patchworkpp_tpu_torch.cli import demo_visualize, eval_semantickitti
from patchworkpp_tpu_torch.io.synthetic import make_scan
from test_eval_gt import CAP, kitti_root  # noqa: F401  (the labelled tree)
from test_torch_frame import _one_torch_thread  # noqa: F401
from test_torch_golden import CAPACITY, synthetic_golden  # noqa: F401

METRICS = ("precision", "recall", "f1", "accuracy")


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("batch", [1, 2])
def test_eval_cli_matches_jax_on_labels(batch, kitti_root, monkeypatch, capsys):  # noqa: F811
    argv = ["--root", str(kitti_root), "--seq", "11", "--capacity", str(CAP), "--json",
            "--batch", str(batch)]
    assert eval_semantickitti.main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["ppk-eval", *argv])
    j_eval.main()
    want = _last_json(capsys.readouterr().out)
    assert got["frames"] == want["frames"] == 2 and got["batch"] == batch
    for k in METRICS:
        assert got[k] == want[k], k
    assert got["f1"] > 0.9 and got["device"] == "cpu"
    assert abs(got["sensor_height"] - want["sensor_height"]) < 1e-5


def test_eval_cli_scores_a_golden_npz(synthetic_golden, capsys):  # noqa: F811
    scan_dir, npz = synthetic_golden
    for batch in (1, 2):
        assert eval_semantickitti.main([
            "--scan-dir", scan_dir, "--golden", npz, "--capacity", str(CAPACITY),
            "--json", "--device", "cpu", "--batch", str(batch)]) == 0
        out = _last_json(capsys.readouterr().out)
        assert out["frames"] == 6
        assert out["precision"] == out["recall"] == out["f1"] == 1.0


def _counts(text):
    lines = dict(line.split(": ", 1) for line in text.splitlines() if ": " in line)
    return int(lines["ground"]), int(lines["nonground"])


def test_demo_visualize_matches_jax(tmp_path, monkeypatch, capsys):
    scan = tmp_path / "000000.bin"
    make_scan(0, 0)[::8].tofile(scan)
    png = tmp_path / "demo.png"
    assert demo_visualize.main([str(scan), "--device", "cpu", "--save", str(png)]) == 0
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["ppk-demo-visualize", str(scan)])
    j_demo.main()
    want = _counts(capsys.readouterr().out)
    assert _counts(out) == want and min(want) > 0
    assert sum(want) == len(make_scan(0, 0)[::8])
    assert png.exists() and png.stat().st_size > 10_000
    assert f"saved: {png}" in out


def test_demo_visualize_refuses_a_missing_scan(tmp_path, monkeypatch):
    monkeypatch.delenv("PPK_DATA_DIR", raising=False)
    with pytest.raises(SystemExit, match="PPK_DATA_DIR"):
        demo_visualize.main(["--device", "cpu"])
    monkeypatch.setenv("PPK_DATA_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="no scan at"):
        demo_visualize.main(["--device", "cpu"])
