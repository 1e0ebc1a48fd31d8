"""The golden gate of the port, and its GPU parity script on the CPU.

On the KITTI scans (the ``scans`` and ``golden`` fixtures of
tests/conftest.py, which skip where ``PPK_DATA_DIR`` does not hold them):
the port's oracle equals the compiled C++ reference's ground indices
(golden/reference_ground_indices.npz), fresh per scan and chained, as
tests/test_oracle_golden.py holds the JAX oracle; the port's CPU path,
tiled and unfused, equals the port's oracle on the scans subsampled [::8]
at capacity 16384, fresh, chained and with 3 columns, as
tests/test_pipeline_golden.py holds the JAX engine; and, marked slow as
the JAX test is, the CPU path equals the golden sets on all 12 full
resolution configurations.

Without the scans, scripts/gpu_parity.py is run here with ``--device cpu``
on six synthetic scans (``io/synthetic.make_scan(0, f)[::8]``) against a
golden-format npz built by the JAX package's facade on the same scans. That
checks the script (its keys, its PASS/FAIL lines, its exit codes, that it
never passes on nothing); it is not parity with the C++ reference.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import SCAN_NAMES
from patchworkpp_tpu.models import PatchworkPP as JPatchworkPP
from patchworkpp_tpu_torch import Params, PatchworkPP
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.oracle import NumpyPatchworkpp
from test_torch_frame import _one_torch_thread  # noqa: F401

SUB = 8
CAPACITY = 16384
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The unfused engine's labels on the synthetic npz's configurations where
# they differ from the JAX default engine's (its per-patch sums follow the
# port's own order: ROADMAP queue 3). None at this size.
UNFUSED_FAILS: list = []


def _gpu_parity():
    spec = importlib.util.spec_from_file_location(
        "gpu_parity", os.path.join(ROOT, "scripts", "gpu_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synthetic_golden(tmp_path_factory):
    """(scan dir, npz): make_scan(0, f)[::8] for f = 0..5 as 000000.bin ..
    000005.bin, and the JAX default engine's ground indices on them at
    capacity 16384 under the golden keys, fresh_<name> and seq_<name>."""
    d = tmp_path_factory.mktemp("synthetic_scans")
    scans = [make_scan(0, f)[::SUB].copy() for f in range(6)]
    for name, s in zip(SCAN_NAMES, scans):
        s.tofile(d / f"{name}.bin")
    m = JPatchworkPP(capacity=CAPACITY)
    keys = {}
    for name, s in zip(SCAN_NAMES, scans):
        m.reset()
        keys[f"fresh_{name}"] = m.estimate_ground(s).ground_indices
    m.reset()
    for name, s in zip(SCAN_NAMES, scans):
        keys[f"seq_{name}"] = m.estimate_ground(s).ground_indices
    npz = d / "golden.npz"
    np.savez(npz, **keys)
    return str(d), str(npz)


def _parity(capsys, *argv):
    rc = _gpu_parity().main(["--device", "cpu", "--capacity", str(CAPACITY), *argv])
    return rc, capsys.readouterr().out.splitlines()


def test_gpu_parity_passes_for_the_kernel_engines(synthetic_golden, capsys):
    scan_dir, npz = synthetic_golden
    rc, out = _parity(capsys, "--scan-dir", scan_dir, "--golden", npz,
                      "--modes", "None", "onehot")
    verdicts = [line for line in out if line.startswith("[fused=")
                and ("PASS" in line or "FAIL" in line)]
    assert len(verdicts) == 24 and all(": PASS (0 mismatched" in v for v in verdicts)
    assert out[-1] == "PARITY: OK" and rc == 0


def test_gpu_parity_on_the_unfused_engine(synthetic_golden, capsys):
    scan_dir, npz = synthetic_golden
    rc, out = _parity(capsys, "--scan-dir", scan_dir, "--golden", npz, "--modes", "False")
    fails = sorted(line.split("]")[1].split(":")[0].strip() for line in out if "FAIL" in line)
    assert fails == UNFUSED_FAILS
    assert (rc == 0) == (not fails)
    assert out[-1] == ("PARITY: OK" if not fails else f"PARITY: {len(fails)} FAILURES")


def test_gpu_parity_fails_on_a_corrupted_key(synthetic_golden, tmp_path, capsys):
    scan_dir, npz = synthetic_golden
    with np.load(npz) as z:
        keys = {k: z[k] for k in z.files}
    keys["seq_000003"] = keys["seq_000003"][1:]  # one ground point lost
    bad = tmp_path / "bad.npz"
    np.savez(bad, **keys)
    rc, out = _parity(capsys, "--scan-dir", scan_dir, "--golden", str(bad), "--modes", "None")
    assert "[fused=None] seq_000003: FAIL (1 mismatched indices)" in out
    assert sum("FAIL" in line for line in out) == 2  # the line and the total
    assert out[-1] == "PARITY: 1 FAILURES" and rc == 1


def test_gpu_parity_never_passes_on_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("PPK_DATA_DIR", raising=False)
    rc, out = _parity(capsys, "--scan-dir", str(tmp_path))
    assert rc != 0 and not any("PARITY" in line for line in out)
    rc, out = _parity(capsys)
    assert rc != 0 and not any("PARITY" in line for line in out)


# ---- the KITTI scans (skip without PPK_DATA_DIR)

@pytest.mark.parametrize("name", SCAN_NAMES)
def test_oracle_fresh_exact(name, scans, golden):
    got = np.flatnonzero(NumpyPatchworkpp().estimate_ground(scans[name]))
    np.testing.assert_array_equal(got, np.sort(golden[f"fresh_{name}"]))


def test_oracle_sequential_exact(scans, golden):
    orc = NumpyPatchworkpp()
    for name in SCAN_NAMES:
        got = np.flatnonzero(orc.estimate_ground(scans[name]))
        np.testing.assert_array_equal(got, np.sort(golden[f"seq_{name}"]), err_msg=name)


@pytest.mark.parametrize("fused", [None, False], ids=["tiled", "unfused"])
def test_cpu_path_matches_oracle_subsampled(fused, scans):
    """Fresh, a 3-scan chain and a 3-column cloud, [::8] at capacity 16384."""
    m = PatchworkPP(capacity=CAPACITY, device="cpu", fused=fused)
    cloud = scans["000000"][::SUB]
    np.testing.assert_array_equal(m.estimate_ground(cloud).ground_mask,
                                  NumpyPatchworkpp().estimate_ground(cloud))
    m.reset()
    orc = NumpyPatchworkpp()
    for name in SCAN_NAMES[:3]:
        cloud = scans[name][::SUB]
        got = m.estimate_ground(cloud).ground_mask
        want = orc.estimate_ground(cloud)
        assert int((got != want).sum()) == 0, f"scan {name}"
        assert abs(m.sensor_height - orc.sensor_height) < 1e-5
    m.reset()
    cloud = scans["000001"][::SUB, :3]
    np.testing.assert_array_equal(m.estimate_ground(cloud).ground_mask,
                                  NumpyPatchworkpp().estimate_ground(cloud))
    p = Params(enable_RVPF=False, enable_TGR=False)
    cloud = scans["000000"][::SUB]
    np.testing.assert_array_equal(
        PatchworkPP(p, capacity=CAPACITY, device="cpu", fused=fused).estimate_ground(cloud).ground_mask,
        NumpyPatchworkpp(p).estimate_ground(cloud))


@pytest.mark.slow
@pytest.mark.parametrize("fused", [None, False], ids=["tiled", "unfused"])
def test_full_resolution_golden(fused, scans, golden):
    """The 12 golden configurations at full resolution on the CPU path."""
    m = PatchworkPP(capacity=131072, device="cpu", fused=fused)
    for variant in ("fresh", "seq"):
        m.reset()
        for name in SCAN_NAMES:
            if variant == "fresh":
                m.reset()
            got = m.estimate_ground(scans[name]).ground_indices
            np.testing.assert_array_equal(got, np.sort(golden[f"{variant}_{name}"]),
                                          err_msg=f"{variant}_{name}")
