"""The port's frame (tiled engine, CPU path) vs the JAX tiled engine on
seeded synthetic clouds (tests/test_fuzz_parity.py:synth_cloud) at capacity
8192, on three chained frames of io/synthetic.py's 64-beam scan at capacity
131072, and the port facade's contract.

Labels must be equal, fresh and through adapted frames. Adaptive-state
counts must be equal. State floats: sensor height and the elevation buffer
are plane centroids, equal to a few float32 ulp (atol 1e-5 m); the flatness
buffer holds each patch's smallest covariance eigenvalue, which the port
computes with XLA:CPU's contractions (ops/eigen3.py) and which therefore
holds the JAX package's bits; the flatness threshold is its mean plus
stdev, a few ulp apart (the largest difference seen is 1.9e-9), so both
take atol 1e-8.

On the boundary-probe clouds (``exact_edges=True``) the port bins every
point as the JAX package does (ops/binning.py rounds each step as XLA:CPU
does), so the labels must be equal there too, with every point kept.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patchworkpp_tpu.state as jstate
import patchworkpp_tpu_torch.pipeline as tpipe
from patchworkpp_tpu.ops.binning import bin_points as j_bin_points
from patchworkpp_tpu.params import CZMGeometry as JGeom
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn
from patchworkpp_tpu_torch import AdaptiveState, CZMGeometry, Params, PatchworkPP, init_state
from patchworkpp_tpu_torch.models.patchworkpp import _round_capacity
from patchworkpp_tpu_torch.ops.binning import bin_points
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_scan
from test_fuzz_parity import CAP, synth_cloud

STATE_ATOL = {"sensor_height": 1e-5, "elevation_thr": 1e-5, "elev_buf": 1e-5,
              "flatness_thr": 1e-8, "flat_buf": 1e-8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread while this module runs: the tests run in
    several worker processes at once, and each worker's thread pool would
    otherwise claim every core. The port's results do not depend on it
    (its order-sensitive sums are written in a fixed order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_frame():
    return jax.jit(j_make_frame_fn(JParams()))


@pytest.fixture(scope="module")
def torch_frame():
    return tpipe.make_frame_fn(Params(), device="cpu")


def _padded(cloud):
    pts = np.zeros((CAP, 4), np.float32)
    pts[: len(cloud), : cloud.shape[1]] = cloud
    return pts


def _chain(seed):
    """Three different clouds, one adaptive chain."""
    return [synth_cloud(seed + 5 * k, exact_edges=False) for k in range(3)]


def _assert_state_close(js, ts, label, atol=STATE_ATOL):
    jn, tn = js.to_numpy(), ts.to_numpy()
    assert sorted(jn) == sorted(tn)
    for k in jn:
        assert jn[k].dtype == tn[k].dtype, k
        if jn[k].dtype.kind == "i":
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=f"{label} {k}")
        else:
            err = float(np.abs(tn[k].astype(np.float64) - jn[k]).max())
            print(f"{label} {k}: max |err| {err:.3e}")
            assert err <= atol[k], (label, k, err)


@pytest.mark.parametrize("seed", range(5))
def test_labels_match_jax_tiled_engine(jax_frame, torch_frame, seed):
    js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
    for k, cloud in enumerate(_chain(seed)):
        pts = _padded(cloud)
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = torch_frame(ts, torch.from_numpy(pts), len(cloud))
        label = f"seed {seed} frame {k}"
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        assert int(tr.num_ground) == int(jr.num_ground) > 0
        np.testing.assert_array_equal(tr.patch_processed.numpy(),
                                      np.asarray(jr.patch_processed), err_msg=label)
        _assert_state_close(js, ts, label)


def test_64_beam_chain_labels_match_jax(jax_frame, torch_frame):
    """io/synthetic.py's 64-beam scan (~120k points), three frames chained at
    capacity 131072. Its frame 2 holds a 17-point, one-tile patch whose
    normal lies 7.6e-4 above the 0.707 uprightness threshold in the JAX
    engine: the port labels it alike only with the JAX engine's tile-sum
    order (ops.row_sum) and fused multiply-adds (ops.fma)."""
    js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
    for k in range(3):
        cloud = make_scan(0, k)
        pts = np.zeros((CAPACITY, 4), np.float32)
        pts[: len(cloud)] = cloud
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = torch_frame(ts, torch.from_numpy(pts), len(cloud))
        label = f"64-beam frame {k}"
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        np.testing.assert_array_equal(tr.patch_processed.numpy(),
                                      np.asarray(jr.patch_processed), err_msg=label)
        _assert_state_close(js, ts, label)


@pytest.mark.parametrize("seed", range(5))
def test_edge_probe_labels_match_without_straddlers(jax_frame, torch_frame, seed):
    """On the boundary-probe clouds the binning leaves no straddler (each
    frame's bins equal the JAX package's, with the adapted sensor height),
    so the labels match with every point kept, fresh and adapted."""
    p, jp = Params(), JParams()
    geom, jgeom = CZMGeometry.create(p), JGeom.create(jp)
    # jitted, as inside the frame program (op-by-op XLA may round otherwise)
    j_bins = jax.jit(lambda pts, n, sh: j_bin_points(pts, n, sh, jp, jgeom))
    js, ts = jstate.init_state(jp), init_state(p, device="cpu")
    for k in range(3):
        cloud = synth_cloud(seed + 5 * k, exact_edges=True)
        pts = _padded(cloud)
        label = f"seed {seed} frame {k}"
        jb = j_bins(jnp.asarray(pts), jnp.int32(len(cloud)), js.sensor_height)
        tb = bin_points(torch.from_numpy(pts), len(cloud), ts.sensor_height, p, geom)
        for f in ("patch_id", "noise", "in_range"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)), err_msg=f"{label} {f}")
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = torch_frame(ts, torch.from_numpy(pts), len(cloud))
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        _assert_state_close(js, ts, label)


def _with_subnormal_patch(seed: int) -> np.ndarray:
    """synth_cloud(seed) with zone 0's ring 0, sectors 0 and 15 (the two
    sides of the +x axis) emptied, and a flat ground patch of 48 points at
    x in [3, 7] m and y = 3e-39, 1e-40 or 1e-45 m put on that axis. Their
    atan2(y, x) is subnormal: XLA:CPU reads it as 0 and wraps the points to
    sector 15, so that sector alone is processed."""
    cloud = synth_cloud(seed, exact_edges=False)
    r = np.hypot(cloud[:, 0], cloud[:, 1])
    th = np.mod(np.arctan2(cloud[:, 1], cloud[:, 0]), 2 * np.pi)
    near_axis = (r < 8.0) & ((th < 2 * np.pi / 16 + 0.05) | (th > 2 * np.pi * 15 / 16 - 0.05))
    rng = np.random.default_rng(seed)
    x = np.tile(np.linspace(3.0, 7.0, 16), 3)
    y = np.repeat(np.float32([3e-39, 1e-40, 1e-45]), 16)
    z = -1.72 + rng.normal(0.0, 0.02, 48)
    patch = np.stack([x, y, z, np.full(48, 0.5)], 1).astype(np.float32)
    assert patch[0, 1] == np.float32(3e-39) and patch[0, 1] < 2.0**-126
    return np.concatenate([cloud[~near_axis], patch]).astype(np.float32)


def test_subnormal_points_label_as_jax(jax_frame, torch_frame):
    """Points with a subnormal coordinate land in the JAX package's patch,
    and the frame's labels, processed patches and state follow, fresh and
    adapted."""
    js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
    for seed in (0, 5):
        cloud = _with_subnormal_patch(seed)
        pts = _padded(cloud)
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = torch_frame(ts, torch.from_numpy(pts), len(cloud))
        label = f"subnormal patch, seed {seed}"
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        np.testing.assert_array_equal(tr.patch_processed.numpy(),
                                      np.asarray(jr.patch_processed), err_msg=label)
        # zone 0, ring 0: sector 15 holds the 48 points, sector 0 none
        assert bool(tr.patch_processed[15]) and not bool(tr.patch_processed[0]), label
        _assert_state_close(js, ts, label)


def test_sequence_matches_frame_loop(torch_frame):
    p = Params()
    clouds = _chain(1)
    stack = torch.from_numpy(np.stack([_padded(c) for c in clouds]))
    st_seq, res = tpipe.make_sequence_fn(p, device="cpu")(
        init_state(p, device="cpu"), stack, [len(c) for c in clouds]
    )
    st = init_state(p, device="cpu")
    for i in range(len(clouds)):
        st, r = torch_frame(st, stack[i], len(clouds[i]))
        for name in r._fields:
            assert torch.equal(getattr(res, name)[i], getattr(r, name)), (i, name)
    for k, v in st.to_numpy().items():
        np.testing.assert_array_equal(st_seq.to_numpy()[k], v, err_msg=k)

    a = PatchworkPP(device="cpu")
    seq = a.estimate_ground_sequence(clouds)
    b = PatchworkPP(capacity=CAP, device="cpu")
    for c, s in zip(clouds, seq):
        r = b.estimate_ground(c)
        np.testing.assert_array_equal(s.ground_mask, r.ground_mask)
        np.testing.assert_array_equal(s.normals, r.normals)
    assert a.sensor_height == b.sensor_height


def test_facade_result_and_state_roundtrip(tmp_path, jax_frame):
    """The facade's result matches the frame's; a state saved by the JAX
    engine continues in the port facade as it does in the JAX engine."""
    clouds = _chain(2)
    js = jstate.init_state(JParams())
    js, _ = jax_frame(js, jnp.asarray(_padded(clouds[0])), jnp.int32(len(clouds[0])))
    path = str(tmp_path / "state.npz")
    js.save(path)
    _, jr = jax_frame(js, jnp.asarray(_padded(clouds[1])), jnp.int32(len(clouds[1])))

    m = PatchworkPP(capacity=CAP, device="cpu")
    m.load_state(path)
    res = m.estimate_ground(clouds[1])
    n = len(clouds[1])
    np.testing.assert_array_equal(res.ground_mask, np.asarray(jr.ground_mask)[:n])
    assert res.ground_mask.shape == (n,)
    np.testing.assert_array_equal(res.ground_indices, np.flatnonzero(res.ground_mask))
    np.testing.assert_array_equal(res.nonground_indices, np.flatnonzero(~res.ground_mask))
    proc = np.asarray(jr.patch_processed)
    assert res.centers.shape == res.normals.shape == (int(proc.sum()), 3)
    assert (res.normals[:, 2] >= 0).all()

    m.save_state(str(tmp_path / "port.npz"))
    back = AdaptiveState.load(str(tmp_path / "port.npz"), device="cpu")
    for k, v in m.state.to_numpy().items():
        np.testing.assert_array_equal(back.to_numpy()[k], v, err_msg=k)
    m.reset()
    for k, v in init_state(Params(), device="cpu").to_numpy().items():
        np.testing.assert_array_equal(m.state.to_numpy()[k], v, err_msg=k)


def test_default_device_is_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PatchworkPP()
    assert PatchworkPP(device="cpu").device.type == "cpu"


def test_three_column_cloud_turns_rnr_off():
    """A 3-column cloud runs with RNR off; its reflected-noise points are
    then binned like any other (the reference refuses RNR without
    intensity), so the result equals RNR disabled on the 4-column cloud."""
    cloud = synth_cloud(4, exact_edges=False)
    r3 = PatchworkPP(capacity=CAP, device="cpu").estimate_ground(cloud[:, :3])
    off = PatchworkPP(Params(enable_RNR=False), capacity=CAP, device="cpu")
    np.testing.assert_array_equal(r3.ground_mask, off.estimate_ground(cloud).ground_mask)
    jfn = jax.jit(j_make_frame_fn(JParams(enable_RNR=False)))
    _, jr = jfn(jstate.init_state(JParams()), jnp.asarray(_padded(cloud[:, :3])),
                jnp.int32(len(cloud)))
    np.testing.assert_array_equal(r3.ground_mask, np.asarray(jr.ground_mask)[: len(cloud)])


@pytest.mark.parametrize("n", [0, 1, 5])
def test_empty_and_tiny_clouds_are_all_nonground(n):
    cloud = synth_cloud(0, exact_edges=False)[:n]
    m = PatchworkPP(device="cpu")
    res = m.estimate_ground(cloud)
    assert res.ground_mask.shape == (n,) and not res.ground_mask.any()
    assert res.ground_indices.size == 0 and res.nonground_indices.size == n
    assert np.isfinite(m.sensor_height)


def test_replay_blocks_do_not_change_labels(torch_frame, monkeypatch):
    cloud = synth_cloud(3, exact_edges=False)
    pts = torch.from_numpy(_padded(cloud))
    _, whole = torch_frame(init_state(Params(), device="cpu"), pts, len(cloud))
    monkeypatch.setattr(tpipe, "_REPLAY_BLOCK", 1000)
    _, blocked = torch_frame(init_state(Params(), device="cpu"), pts, len(cloud))
    assert torch.equal(whole.ground_mask, blocked.ground_mask)


def test_capacity_buckets():
    from patchworkpp_tpu.models.patchworkpp import _round_capacity as j_round

    for n in (0, 1, 8191, 8192, 8193, 120000, 131072):
        assert _round_capacity(n) == j_round(n)
    m = PatchworkPP(capacity=CAP, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        m.estimate_ground(np.zeros((CAP + 1, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(N,3\) or \(N,4\)"):
        m.estimate_ground(np.zeros((10, 5), np.float32))
