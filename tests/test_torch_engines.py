"""The port's ``fused=`` engine switch, end to end on the CPU at capacity
8192, against the JAX package's engines on seeded synthetic clouds
(tests/test_fuzz_parity.py:synth_cloud).

- ``fused=False`` (the unfused engine) and ``fused="onehot"`` (the
  unrolled fit kernel K2's plain version) give the labels of the JAX
  package's same engines (the onehot one in interpret mode), fresh and
  through two adapted frames. The adaptive state is held to the tolerances
  of tests/test_torch_frame.py (integers equal), the flatness state to
  ``ENGINE_STATE_ATOL`` (reason given there).
- On the boundary-probe clouds the port's tiled, onehot and unfused
  engines give equal labels, as the JAX engines do
  (test_fuzz_parity.py:test_fuzz_engines_agree_on_edges).
- Every mode of the switch reaches the engine the JAX package maps it to;
  an unknown mode raises the JAX package's ValueError.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.state as jstate
import patchworkpp_tpu_torch.pipeline as tpipe
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn
from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import (  # noqa: F401
    _assert_state_close,
    _chain,
    _one_torch_thread,
    _padded,
)

# These engines' per-patch sums are added in another order than the JAX
# engines' (one-hot dots), so their covariances, and the flatness state
# (smallest eigenvalues) built from them, agree to a few ulp of the sums
# through Cardano's small-root conditioning; the largest difference seen is
# 1.2e-6 (the unfused engine). Their sums depend on the host (ROADMAP,
# queue 3), so every state float keeps 1e-5.
ENGINE_STATE_ATOL = {"sensor_height": 1e-5, "elevation_thr": 1e-5, "elev_buf": 1e-5,
                     "flatness_thr": 1e-5, "flat_buf": 1e-5}


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's engines, each compiled once for the module."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = jax.jit(j_make_frame_fn(JParams(), fused=mode, interpret=True))
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def port_frames():
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = tpipe.make_frame_fn(Params(), device="cpu", fused=mode)
        return cache[mode]

    return get


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mode", [False, "onehot"])
def test_engine_labels_match_jax(jax_frames, port_frames, mode, seed):
    jf, tf = jax_frames(mode), port_frames(mode)
    js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
    for k, cloud in enumerate(_chain(seed)):
        pts = _padded(cloud)
        js, jr = jf(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = tf(ts, torch.from_numpy(pts), len(cloud))
        label = f"fused={mode!r} seed {seed} frame {k}"
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        assert int(tr.num_ground) == int(jr.num_ground) > 0
        np.testing.assert_array_equal(tr.patch_processed.numpy(),
                                      np.asarray(jr.patch_processed), err_msg=label)
        _assert_state_close(js, ts, label, ENGINE_STATE_ATOL)


@pytest.mark.parametrize("seed", range(5))
def test_port_engines_agree_on_edges(port_frames, seed):
    """Boundary-probe clouds, three chained frames: tiled == onehot ==
    unfused labels, and the same adapted sensor height."""
    modes = ("tiled", "onehot", False)
    states = {m: init_state(Params(), device="cpu") for m in modes}
    for k in range(3):
        cloud = synth_cloud(seed + 5 * k, exact_edges=True)
        pts = torch.from_numpy(_padded(cloud))
        res = {}
        for m in modes:
            states[m], res[m] = port_frames(m)(states[m], pts, len(cloud))
        for m in modes[1:]:
            assert torch.equal(res[m].ground_mask, res["tiled"].ground_mask), (m, k)
    for m in modes[1:]:
        assert torch.equal(states[m].sensor_height, states["tiled"].sensor_height), m


def test_onehot_sequence_matches_frame_loop(port_frames):
    p = Params()
    clouds = _chain(1)
    stack = torch.from_numpy(np.stack([_padded(c) for c in clouds]))
    npts = [len(c) for c in clouds]
    st_seq, res = tpipe.make_sequence_fn(p, device="cpu", fused="onehot")(
        init_state(p, device="cpu"), stack, npts
    )
    st = init_state(p, device="cpu")
    for i in range(len(clouds)):
        st, r = port_frames("onehot")(st, stack[i], npts[i])
        for name in r._fields:
            assert torch.equal(getattr(res, name)[i], getattr(r, name)), (i, name)
    for k, v in st.to_numpy().items():
        np.testing.assert_array_equal(st_seq.to_numpy()[k], v, err_msg=k)

    seq = PatchworkPP(capacity=CAP, device="cpu", fused="onehot").estimate_ground_sequence(clouds)
    one = PatchworkPP(capacity=CAP, device="cpu", fused="onehot")
    for c, s in zip(clouds, seq):
        np.testing.assert_array_equal(s.ground_mask, one.estimate_ground(c).ground_mask)


@pytest.mark.parametrize("mode", [None, True, "grid", "grid_iota", "tiled", "onehot", False])
def test_facade_modes_reach_their_engine(port_frames, mode):
    """PatchworkPP(fused=mode) runs the frame of the engine the JAX package
    maps the mode to: None -> tiled, True -> grid; the K1 modes are one
    engine here."""
    engine = {None: "tiled", True: "tiled", "grid": "tiled", "grid_iota": "tiled"}.get(mode, mode)
    cloud = synth_cloud(2, exact_edges=False)
    res = PatchworkPP(capacity=CAP, device="cpu", fused=mode).estimate_ground(cloud)
    _, want = port_frames(engine)(init_state(Params(), device="cpu"),
                                  torch.from_numpy(_padded(cloud)),
                                  len(cloud))
    np.testing.assert_array_equal(res.ground_mask, want.ground_mask.numpy()[: len(cloud)])


@pytest.mark.parametrize("mode", ["scan", "fused", 2])
def test_unknown_mode_raises(mode):
    with pytest.raises(ValueError, match="unknown fused mode") as theirs:
        j_make_frame_fn(JParams(), fused=mode)
    with pytest.raises(ValueError, match="unknown fused mode") as ours:
        tpipe.make_frame_fn(Params(), device="cpu", fused=mode)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown fused mode"):
        PatchworkPP(device="cpu", fused=mode).estimate_ground(synth_cloud(0, exact_edges=False))
