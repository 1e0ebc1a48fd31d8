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
- The unfused engine's per-patch sum, ``ops.patch_reduce`` (the kernel KR on
  the card, ``ops/patch_reduce_kernel.py``; its plain version
  ``patch_reduce_reference`` on the CPU): the plain version equals, bit for
  bit, a float32 sum written out here (128-row chunks from each patch's
  first row, each summed by zero-padded halving, the chunk sums folded left
  from +0.0, stopping at the patch's own chunk count) over empty patches,
  one-chunk patches, -0.0 addends, cancelling sums and the overflow bucket;
  it equals the JAX package's ``patch_reduce`` (a one-hot dot whose order
  is the host's) within the float64 sum's 1e-5 of tests/test_ops.py. The
  wrapper runs the plain version on a CPU tensor without counting, and KR
  raises on a tensor that is not on CUDA; on the card (``gpu``) KR equals
  the plain version bit for bit, in both modes (the moment mode's CPU tests
  are tests/test_torch_patch_reduce.py).
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


# ---------------------------------------------------------------- the per-patch sum

def _patch_runs(rng, counts, cols):
    """Sorted rows for per-patch ``counts`` (the last patch the overflow
    bucket): (feats, patch_id, start) as numpy arrays."""
    counts = np.asarray(counts)
    start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    pid = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    feats = rng.normal(size=(int(counts.sum()), cols)).astype(np.float32)
    return feats, pid, start


def _fold_sum(feats, start):
    """The per-patch sum as KR computes it, in float32 numpy: each patch's
    rows in 128-row chunks, a chunk zero-padded and halved in place, the
    chunk sums added left to right from +0.0 (its own chunks only)."""
    out = np.zeros((len(start) - 1, feats.shape[1]), np.float32)
    for s in range(len(start) - 1):
        acc = np.zeros(feats.shape[1], np.float32)  # +0.0
        for lo in range(start[s], start[s + 1], 128):
            v = np.zeros((128, feats.shape[1]), np.float32)
            rows = feats[lo:min(lo + 128, start[s + 1])]
            v[: len(rows)] = rows
            while len(v) > 1:
                v = v[: len(v) // 2] + v[len(v) // 2:]
            acc = acc + v[0]
        out[s] = acc
    return out


def _kr_cases():
    """name -> (feats, patch_id, start): the hazards of the fixed order."""
    rng = np.random.default_rng(7)
    cases = {}
    # empty patches among one-chunk, exactly-one-chunk and multi-chunk ones,
    # and a long overflow bucket last
    cases["mixed"] = _patch_runs(rng, [0, 1, 5, 128, 0, 129, 300, 0, 0, 1000, 2, 700], 10)
    # -0.0 addends: whole patches of -0.0 (one chunk, and more than one),
    # and -0.0 scattered among values
    f, pid, st = _patch_runs(rng, [3, 128, 256, 400, 1, 0, 90], 4)
    f[: st[4]] = -0.0
    f[st[4]:][rng.random(f[st[4]:].shape) < 0.5] = -0.0
    cases["signed_zeros"] = (f, pid, st)
    # cancelling sums: +x and -x in one chunk and across chunks, and huge
    # terms that absorb small ones
    f, pid, st = _patch_runs(rng, [256, 384, 129, 64], 3)
    f[:, 0] = np.where(np.arange(len(f)) % 2, 1e7, -1e7).astype(np.float32)
    f[: st[1], 1] = np.concatenate([f[:128, 1], -f[:128, 1]])
    f[:, 2] = np.where(np.arange(len(f)) % 3 == 0, 3e8, 1.5).astype(np.float32)
    cases["cancelling"] = (f, pid, st)
    return cases


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", ["mixed", "signed_zeros", "cancelling"])
def test_patch_reduce_plain_equals_chunk_fold(case):
    """Tolerance 0: the plain version and the fold written here add the same
    float32 values in the same tree and order; every patch of -0.0 sums to
    +0.0 (the fold starts from +0.0)."""
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference

    feats, pid, start = _kr_cases()[case]
    got = patch_reduce_reference(torch.from_numpy(feats), torch.from_numpy(pid),
                                 torch.from_numpy(start)).numpy()
    want = _fold_sum(feats, start)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    counts = np.diff(start)
    assert (_bits(got[counts == 0]) == 0).all()  # empty patches: +0.0
    if case == "signed_zeros":
        assert (_bits(got[:4]) == 0).all()  # -0.0 rows sum to +0.0, not -0.0


def test_patch_reduce_matches_jax_patch_reduce():
    """The port's fixed order against the JAX package's one-hot dot over the
    same rows and the 512-wide patch space: within 1e-5 (rtol and atol, the
    float64 reference's tolerance in tests/test_ops.py); the order differs,
    so the bits may."""
    from patchworkpp_tpu.ops.onehot import patch_reduce as j_patch_reduce

    from patchworkpp_tpu_torch.ops import SPAD, patch_reduce

    rng = np.random.default_rng(3)
    counts = rng.integers(0, 40, SPAD)
    counts[::9] = 0
    counts[17] = 700
    feats, pid, start = _patch_runs(rng, counts, 10)
    got = patch_reduce(torch.from_numpy(feats), torch.from_numpy(pid),
                       torch.from_numpy(start)).numpy()
    want = np.asarray(jax.jit(j_patch_reduce)(jnp.asarray(feats), jnp.asarray(pid)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_patch_reduce_runs_plain_on_cpu_without_counting():
    """``ops.patch_reduce`` on CPU tensors is the plain version (KR is not
    launched); KR itself refuses CPU and other non-CUDA tensors."""
    from patchworkpp_tpu_torch.ops import patch_reduce
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference
    from patchworkpp_tpu_torch.ops.patch_reduce_kernel import patch_reduce_kernel

    feats, pid, start = (torch.from_numpy(a) for a in _kr_cases()["mixed"])
    before = patch_reduce_kernel.launches
    got = patch_reduce(feats, pid, start)
    assert patch_reduce_kernel.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(patch_reduce_reference(feats, pid, start)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        patch_reduce_kernel(feats, start)
    with pytest.raises(ValueError, match="CUDA tensors"):
        patch_reduce(feats.to("meta"), pid.to("meta"), start.to("meta"))


def test_patch_reduce_argtypes_follow_extern_c_signature():
    from test_torch_fit import _extern_c_argtypes

    from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr

    assert list(kr.ARGTYPES) == _extern_c_argtypes(kr.SOURCE, "ppk_patch_reduce")


def _kr_card_cases():
    """_kr_cases and what the chunk-parallel kernel adds: one patch of 313
    chunks (40,064 rows, the crowded cloud's largest), and the column counts
    1, 2, 10, the widest the generic mode takes (32), and 70 (three calls
    of 32, 32 and 6 columns)."""
    cases = _kr_cases()
    rng = np.random.default_rng(11)
    cases["one_patch_313_chunks"] = _patch_runs(rng, [40064], 2)
    counts = [0, 1, 5, 128, 129, 0, 700, 3, 0, 300]
    for cols in (1, 2, 10, 32, 70):
        cases[f"cols{cols}"] = _patch_runs(rng, counts, cols)
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "signed_zeros", "cancelling", "one_patch_313_chunks",
                                  "cols1", "cols2", "cols10", "cols32", "cols70", "moments"])
def test_cuda_patch_reduce_matches_plain_on_card(case):
    """KR against its plain version on the same CUDA tensors: the same adds
    in the same order, so bit for bit; one call counted (a call a 32-column
    slice). ``moments``: the
    moment mode against the plain version of the monomial table
    (tests/test_torch_patch_reduce.py:_moment_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py makes this check on the card)")
    from patchworkpp_tpu_torch.ops.moments import masked_moment_features_cols
    from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference
    from patchworkpp_tpu_torch.ops.patch_reduce_kernel import (
        patch_moment_sums_kernel,
        patch_reduce_kernel,
    )

    before = patch_reduce_kernel.launches
    if case == "moments":
        from test_torch_patch_reduce import _moment_cases

        for cols, pid, start in _moment_cases().values():
            cols = [torch.from_numpy(a).cuda() for a in cols]
            pid, start = torch.from_numpy(pid).cuda(), torch.from_numpy(start).cuda()
            got = patch_moment_sums_kernel(*cols, start)
            torch.cuda.synchronize()
            want = patch_reduce_reference(masked_moment_features_cols(*cols), pid, start)
            np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))
        assert patch_reduce_kernel.launches == before + len(_moment_cases())
        return
    feats, pid, start = (torch.from_numpy(a).cuda() for a in _kr_card_cases()[case])
    got = patch_reduce_kernel(feats, start)
    torch.cuda.synchronize()
    assert patch_reduce_kernel.launches == before + -(-feats.shape[1] // 32)
    want = patch_reduce_reference(feats, pid, start)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(want.cpu()))
