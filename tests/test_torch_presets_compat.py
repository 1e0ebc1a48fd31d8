"""The port's presets, ROS launch parameters and pypatchworkpp compat module
against the JAX package's, on the seeded clouds of
tests/test_fuzz_parity.py:synth_cloud at capacity 8192.

Each preset runs a K1 pass program that the default parameters do not:
``patchwork_params`` has R-VPF and TGR off (no vertical-snapshot passes),
``ros_launch_params`` has num_min_pts=0 (patches with very few points are
processed). Their tiled-engine labels must equal the reference's, fresh and
through adapted frames: ``patchwork_params``' the JAX engine's, state floats
within test_torch_frame.py's tolerances; ``ros_launch_params``' the port's
NumPy oracle's, with its buffer counts, state floats within 1e-5. At
num_min_pts=0 an empty patch takes the previous patch's plane, as the C++
reference's members do (pipeline.carry_planes), where the JAX engine gives
it a zero plane; the clouds of that case are thinned of the patches that
hold 2 to 19 points, where the fits of exactly two points lie whose normal
is solver-arbitrary (``NumpyPatchworkpp.two_point_fits``, 0 on these three).
The compat getters' index sets must equal the JAX
compat module's; the patch centers within 1e-5 m (means of the same points)
and the normals within 2e-3 (a clustered pair's normal differs in its last
bits, ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.compat import pypatchworkpp as j_compat
from patchworkpp_tpu.models import presets as j_presets
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn
from patchworkpp_tpu.serve.launch import launch_node_parameters as j_launch_params
from patchworkpp_tpu_torch import init_state
from patchworkpp_tpu_torch.compat import pypatchworkpp
from patchworkpp_tpu_torch.models import PatchworkPP, presets
from patchworkpp_tpu_torch.oracle import NumpyPatchworkpp
from patchworkpp_tpu_torch.pipeline import make_frame_fn
from patchworkpp_tpu_torch.serve.launch import launch_node_parameters
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import _assert_state_close, _one_torch_thread  # noqa: F401
from test_torch_launch_profile import thin_indeterminate

PRESETS = ("patchwork_params", "ros_launch_params")


def _padded(cloud):
    pts = np.zeros((CAP, 4), np.float32)
    pts[: len(cloud), : cloud.shape[1]] = cloud
    return pts


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_match_jax(name):
    port, ref = getattr(presets, name)(), getattr(j_presets, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    over = getattr(presets, name)(num_iter=2, th_dist=0.2)
    assert dataclasses.asdict(over) == dataclasses.asdict(
        getattr(j_presets, name)(num_iter=2, th_dist=0.2))


def test_presets_turn_off_what_they_say():
    pw = presets.patchwork_params()
    assert not (pw.enable_RNR or pw.enable_RVPF or pw.enable_TGR)
    ros = presets.ros_launch_params()
    assert ros.num_min_pts == 0 and not ros.enable_RNR and ros.sensor_height == 1.88


def test_launch_node_parameters_match_jax():
    for kw in ({}, {"base_frame": "lidar", "use_sim_time": False}):
        assert launch_node_parameters(**kw) == j_launch_params(**kw)
    p = launch_node_parameters()
    ros = presets.ros_launch_params()
    assert p["th_dist_v"] == ros.th_dist_v == 0.9
    assert p["uprightness_thr"] == ros.uprightness_thr == 0.101


def _assert_state_near_oracle(o: NumpyPatchworkpp, ts, label):
    st = ts.to_numpy()
    assert st["elev_cnt"].tolist() == [len(b) for b in o.update_elevation], label
    assert st["flat_cnt"].tolist() == [len(b) for b in o.update_flatness], label
    for k in ("sensor_height", "elevation_thr", "flatness_thr"):
        np.testing.assert_allclose(st[k], getattr(o, k), rtol=0, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_labels_match_jax_tiled_engine(name):
    """Three chained clouds (fresh, then adapted) through each preset."""
    jp, tp = getattr(j_presets, name)(), getattr(presets, name)()
    oracle = name == "ros_launch_params"
    if oracle:
        o = NumpyPatchworkpp(tp)
    else:
        jfn = jax.jit(j_make_frame_fn(jp))
        js = jstate.init_state(jp)
    tfn = make_frame_fn(tp, device="cpu")
    ts = init_state(tp, device="cpu")
    for k in range(3):
        cloud = synth_cloud(2 + 5 * k, exact_edges=False)
        if oracle:
            cloud = thin_indeterminate(cloud, tp, most=19)
        pts = _padded(cloud)
        ts, tr = tfn(ts, torch.from_numpy(pts), len(cloud))
        label = f"{name} frame {k}"
        got = tr.ground_mask.numpy()
        if oracle:
            want = o.estimate_ground(cloud)
            np.testing.assert_array_equal(got[:len(cloud)], want, err_msg=label)
            assert not got[len(cloud):].any(), label
            assert 0 < int(tr.num_ground) == int(want.sum())
            _assert_state_near_oracle(o, ts, label)
            continue
        js, jr = jfn(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        np.testing.assert_array_equal(got, np.asarray(jr.ground_mask), err_msg=label)
        np.testing.assert_array_equal(tr.patch_processed.numpy(),
                                      np.asarray(jr.patch_processed), err_msg=label)
        assert 0 < int(tr.num_ground) == int(jr.num_ground)
        _assert_state_close(js, ts, label)
    if oracle:
        # num_min_pts=0: every real patch is processed, empty ones included
        assert o.two_point_fits == 0
        assert bool(tr.patch_processed.all())
        assert len(o.centers) == tr.patch_processed.shape[0]


def test_compat_parameters_surface_matches_jax():
    port, ref = pypatchworkpp.Parameters(), j_compat.Parameters()
    assert vars(port) == vars(ref)
    assert len(vars(port)) == 27  # the 25 tunables, zone lists counted apart
    for bag in (port, ref):
        bag.num_min_pts = 3
        bag.th_dist = 0.2
        bag.elevation_thr = [0.5, 0.8, 1.0, 1.1]
    assert dataclasses.asdict(port._freeze()) == dataclasses.asdict(ref._freeze())


def test_compat_getters_match_jax():
    cloud = synth_cloud(3, exact_edges=False)
    eng = pypatchworkpp.patchworkpp(pypatchworkpp.Parameters(), device="cpu")
    ref = j_compat.patchworkpp(j_compat.Parameters())
    with pytest.raises(RuntimeError, match="estimateGround"):
        eng.getGround()
    for step in range(2):  # fresh, then adapted
        c = cloud if step == 0 else synth_cloud(8, exact_edges=False)
        eng.estimateGround(c)
        ref.estimateGround(c)
        for getter in ("getGroundIndices", "getNongroundIndices", "getGround",
                       "getNonground"):
            np.testing.assert_array_equal(getattr(eng, getter)(), getattr(ref, getter)(),
                                          err_msg=getter)
        np.testing.assert_allclose(eng.getCenters(), ref.getCenters(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(eng.getNormals(), ref.getNormals(), rtol=0, atol=2e-3)
        assert abs(eng.getHeight() - ref.getHeight()) <= 1e-5
        assert eng.getTimeTaken() > 0


def test_compat_requires_keyword_device():
    with pytest.raises(TypeError):
        pypatchworkpp.patchworkpp(pypatchworkpp.Parameters(), "cpu")
    assert isinstance(pypatchworkpp.patchworkpp(device="cpu")._model, PatchworkPP)
