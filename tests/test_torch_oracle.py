"""The port's NumPy oracle (patchworkpp_tpu_torch/oracle) against the JAX
package's (patchworkpp_tpu/oracle), and the port's engines against it.

The two oracles are one program on two eigensolvers: the port's runs
ops/eigen3.py on 0-d CPU tensors, the JAX one the jitted JAX solver. They
agree bit for bit on separated eigenvalue pairs and may differ in the last
bits of a clustered pair's normal, so the bar is equal labels, the same
binning (``last_patch_id``), the same count of two-point fits and the
adapted sensor height within 1e-6. Inputs: the seeded clouds of
tests/test_fuzz_parity.py:synth_cloud (clean variant: f32-decidable bins),
fresh and adapted (the same cloud twice), and the synthetic 64-beam scan
``io/synthetic.make_scan(0, f)`` chained at full width.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from patchworkpp_tpu.oracle import NumpyPatchworkpp as JOracle
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu_torch import Params, PatchworkPP
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.oracle import NumpyPatchworkpp
from patchworkpp_tpu_torch.oracle import numpy_oracle
from test_fuzz_parity import synth_cloud
from test_torch_frame import _one_torch_thread  # noqa: F401

# The synthetic 64-beam configurations (make_scan(0, f), capacity 131072)
# where the engines' labels differ from the oracle's, and by how many
# points; the engines equal the oracle on every other one. The JAX tiled
# and unfused engines and the port's tiled and onehot engines give the same
# labels on all twelve; the port's unfused engine takes the oracle's side on
# fresh_000002, fresh_000003 and seq_000002 (ROADMAP queue 3). chip_smoke.py
# holds the card to this table.
ENGINE_VS_ORACLE = {"fresh_000002": 17, "fresh_000003": 1, "fresh_000005": 16,
                    "seq_000002": 17, "seq_000005": 16}
PATCH_290 = 290


def _both(cloud, port, jax_oracle):
    """Run both oracles on ``cloud``; labels, binning and diagnostics equal."""
    got, want = port.estimate_ground(cloud), jax_oracle.estimate_ground(cloud)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.last_patch_id, jax_oracle.last_patch_id)
    assert port.two_point_fits == jax_oracle.two_point_fits
    assert abs(port.sensor_height - jax_oracle.sensor_height) <= 1e-6
    return got


@pytest.mark.parametrize("seed", range(5))
def test_oracle_matches_jax_oracle_on_seeded_clouds(seed):
    cloud = synth_cloud(seed, exact_edges=False)
    port, jo = NumpyPatchworkpp(), JOracle()
    fresh = _both(cloud, port, jo)
    _both(cloud, port, jo)  # adapted: the same cloud again
    assert 0 < fresh.sum() < len(cloud)
    assert port.sensor_height != Params().sensor_height
    np.testing.assert_allclose(port.elevation_thr, jo.elevation_thr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.flatness_thr, jo.flatness_thr, rtol=0, atol=1e-6)


def test_oracle_matches_jax_oracle_without_rvpf_and_tgr():
    kw = dict(enable_RVPF=False, enable_TGR=False)
    cloud = synth_cloud(3, exact_edges=False)
    port, jo = NumpyPatchworkpp(Params(**kw)), JOracle(JParams(**kw))
    _both(cloud, port, jo)
    _both(cloud, port, jo)


def test_oracle_on_the_64_beam_chain():
    """make_scan(0, 0..2) chained at full width: the two oracles agree, and
    the port's tiled engine equals the oracle on frames 0 and 1; on frame 2
    it calls 17 points of patch 290 ground that the oracle calls non-ground
    (the near-tie of ROADMAP queue 3)."""
    port, jo = NumpyPatchworkpp(), JOracle()
    eng = PatchworkPP(capacity=131072, device="cpu")
    for f in range(3):
        scan = make_scan(0, f)
        want = _both(scan, port, jo)
        assert port.two_point_fits == 0
        got = eng.estimate_ground(scan).ground_mask
        diff = np.flatnonzero(got != want)
        assert len(diff) == ENGINE_VS_ORACLE.get(f"seq_{f:06d}", 0), f"frame {f}"
        if len(diff):
            assert set(port.last_patch_id[diff]) == {PATCH_290}
            assert got[diff].all() and not want[diff].any()


def test_eigensolver_is_a_seam(monkeypatch):
    """``_shared_eig3`` is what every plane fit calls, so a test can swap in
    an independent solver (as tests/test_oracle_golden.py does for the JAX
    oracle): float64 ``np.linalg.eigh`` gives the same labels here."""
    cloud = synth_cloud(1, exact_edges=False)
    want = NumpyPatchworkpp().estimate_ground(cloud)
    calls = []

    def eigh_f64(*entries):
        a00, a01, a02, a11, a12, a22 = (np.float64(v) for v in entries)
        w, v = np.linalg.eigh(np.array([[a00, a01, a02], [a01, a11, a12],
                                        [a02, a12, a22]]))
        calls.append(1)
        n = v[:, 0].astype(np.float32)
        return (np.float32(w[2]), np.float32(w[1]), np.float32(w[0]), n[0], n[1], n[2])

    monkeypatch.setattr(numpy_oracle, "_shared_eig3", lambda: eigh_f64)
    got = NumpyPatchworkpp().estimate_ground(cloud)
    assert calls
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_engines_vs_oracle_on_twelve_64_beam_configurations():
    """All twelve configurations (make_scan(0, 0..5), fresh and chained) at
    full width: the port's oracle equals the JAX oracle, and the port's
    tiled engine differs from it exactly where ENGINE_VS_ORACLE says."""
    scans = [make_scan(0, f) for f in range(6)]
    eng = PatchworkPP(capacity=131072, device="cpu")
    chain_port, chain_jax = NumpyPatchworkpp(), JOracle()
    for variant in ("fresh", "seq"):
        eng.reset()
        for f, scan in enumerate(scans):
            if variant == "fresh":
                eng.reset()
                port, jo = NumpyPatchworkpp(), JOracle()
            else:
                port, jo = chain_port, chain_jax
            want = _both(scan, port, jo)
            got = eng.estimate_ground(scan).ground_mask
            key = f"{variant}_{f:06d}"
            assert int((got != want).sum()) == ENGINE_VS_ORACLE.get(key, 0), key


def test_chip_smoke_holds_the_card_to_this_table():
    """chip_smoke.py's references phase keeps its own copy of the table
    (it runs where no test module can be imported); the two must agree."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.ENGINE_VS_ORACLE == ENGINE_VS_ORACLE
