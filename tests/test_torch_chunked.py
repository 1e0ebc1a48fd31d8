"""The port's chunked frame (parallel/chunked.py: the point-sharded
per-shard program over K chunk threads of one device) against the port's
single-device frame and the JAX package's chunked engine
(patchworkpp_tpu/parallel/chunked.py), on the CPU at capacity 8192: the
64-beam scans io/synthetic.make_scan(0, 0..2)[::16] (~7.5k points) and a
seeded cloud of tests/test_fuzz_parity.py:synth_cloud (analogs of JAX
tests/test_chunked.py:55, 141, 184, 204, 241, 255, 262).

Labels must be equal to both. Against the JAX chunked engine, the patch
tables are within test_torch_fit.py's tolerance (atol 5e-5 + rtol 5e-5)
and the state within test_torch_frame.py's; between the port's own paths
(the sequence and the frame loop) every field is equal bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.parallel import make_chunked_frame_fn as j_chunked
from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.parallel import make_chunked_frame_fn, make_chunked_sequence_fn
from patchworkpp_tpu_torch.pipeline import make_frame_fn, make_sequence_fn
from test_fuzz_parity import CAP, synth_cloud
from test_torch_fit import ATOL, RTOL
from test_torch_frame import _assert_state_close, _one_torch_thread  # noqa: F401

SUB = 16


def _padded(cloud):
    pts = np.zeros((CAP, 4), np.float32)
    pts[: len(cloud)] = cloud
    return pts


@pytest.fixture(scope="module")
def clouds():
    return [make_scan(0, f)[::SUB] for f in range(3)] + [synth_cloud(0, exact_edges=False)]


@pytest.fixture(scope="module")
def single(clouds):
    """The port's single-device frame on each cloud, fresh."""
    fn = make_frame_fn(Params(), device="cpu")
    return [fn(init_state(Params(), device="cpu"), torch.from_numpy(_padded(c)), len(c))
            for c in clouds]


def _assert_tables_close(tr, jr, label):
    np.testing.assert_array_equal(tr.patch_processed.numpy(), np.asarray(jr.patch_processed),
                                  err_msg=label)
    for f in ("patch_mean", "patch_normal", "patch_svals"):
        got = getattr(tr, f).numpy().astype(np.float64)
        want = np.asarray(getattr(jr, f)).astype(np.float64)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=f"{label} {f}")
        np.testing.assert_array_less(np.abs(got - want)[fin], ATOL + RTOL * np.abs(want[fin]),
                                     err_msg=f"{label} {f}")


@pytest.mark.parametrize("num_chunks", [2, 4, 8])
def test_chunked_frame_equals_single_and_jax(clouds, single, num_chunks):
    fn = make_chunked_frame_fn(Params(), num_chunks, device="cpu")
    jfn = j_chunked(JParams(), num_chunks)
    for i, c in enumerate(clouds):
        pts = _padded(c)
        st, res = fn(init_state(Params(), device="cpu"), torch.from_numpy(pts), len(c))
        jst, jres = jfn(jstate.init_state(JParams()), jnp.asarray(pts), jnp.int32(len(c)))
        label = f"K={num_chunks} cloud {i}"
        np.testing.assert_array_equal(res.ground_mask.numpy(), single[i][1].ground_mask.numpy(),
                                      err_msg=f"{label} vs single")
        np.testing.assert_array_equal(res.ground_mask.numpy(), np.asarray(jres.ground_mask),
                                      err_msg=f"{label} vs jax chunked")
        assert int(res.num_ground) == int(jres.num_ground) == int(res.ground_mask.sum()) > 0
        _assert_tables_close(res, jres, label)
        _assert_state_close(jst, st, label)


def test_chunked_sequence_matches_frame_loop(clouds):
    """One sequence call == the chunked frame loop, bit for bit (every field
    and the state), and its labels == the single-device sequence's."""
    p = Params()
    stack = torch.from_numpy(np.stack([_padded(c) for c in clouds[:3]]))
    npts = [len(c) for c in clouds[:3]]
    st_seq, res = make_chunked_sequence_fn(p, 4, device="cpu")(
        init_state(p, device="cpu"), stack, npts)
    frame = make_chunked_frame_fn(p, 4, device="cpu")
    st = init_state(p, device="cpu")
    for i in range(3):
        st, r = frame(st, stack[i], npts[i])
        for f in r._fields:
            np.testing.assert_array_equal(getattr(res, f)[i].numpy(), getattr(r, f).numpy(),
                                          err_msg=f"frame {i} {f}")
    a, b = st_seq.to_numpy(), st.to_numpy()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, res_s = make_sequence_fn(p, device="cpu")(init_state(p, device="cpu"), stack, npts)
    np.testing.assert_array_equal(res.ground_mask.numpy(), res_s.ground_mask.numpy())


def test_facade_chunks_exact(clouds, single):
    """PatchworkPP(chunks=K) returns the plain facade's labels, frame by
    frame and through the sequence; an automatic capacity rounds to a
    multiple of lcm(8192, K); a fixed capacity K does not divide raises."""
    c0, c1 = clouds[0], clouds[1]
    want = single[0][1].ground_mask.numpy()[: len(c0)]
    m = PatchworkPP(chunks=4, device="cpu")
    np.testing.assert_array_equal(m.estimate_ground(c0).ground_mask, want)
    m.reset()
    seq = m.estimate_ground_sequence([c0, c1])
    np.testing.assert_array_equal(seq[0].ground_mask, want)
    plain = PatchworkPP(device="cpu")
    plain.estimate_ground(c0)
    np.testing.assert_array_equal(seq[1].ground_mask, plain.estimate_ground(c1).ground_mask)
    assert m.sensor_height == plain.sensor_height

    m3 = PatchworkPP(chunks=3, device="cpu")
    cap = m3._capacity(len(c0))
    assert cap % 3 == 0 and cap % 8192 == 0
    np.testing.assert_array_equal(m3.estimate_ground(c0).ground_mask, want)
    with pytest.raises(ValueError, match="not divisible"):
        PatchworkPP(capacity=1000, chunks=3, device="cpu").estimate_ground(c0[:100])


def test_chunked_unfused_exact_vs_single_and_jax(clouds):
    """The unfused engine chunked (its LPR through MeshComm.lpr_stats):
    labels == the port's single-device unfused frame and the JAX chunked
    unfused engine's."""
    c = clouds[0]
    pts = _padded(c)
    _, want = make_frame_fn(Params(), device="cpu", fused=False)(
        init_state(Params(), device="cpu"), torch.from_numpy(pts), len(c))
    _, res = make_chunked_frame_fn(Params(), 8, fused=False, device="cpu")(
        init_state(Params(), device="cpu"), torch.from_numpy(pts), len(c))
    _, jres = j_chunked(JParams(), 8, fused=False)(
        jstate.init_state(JParams()), jnp.asarray(pts), jnp.int32(len(c)))
    np.testing.assert_array_equal(res.ground_mask.numpy(), want.ground_mask.numpy())
    np.testing.assert_array_equal(res.ground_mask.numpy(), np.asarray(jres.ground_mask))


def test_chunked_rejects_indivisible_capacity():
    fn = make_chunked_frame_fn(Params(), 3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        fn(init_state(Params(), device="cpu"), torch.zeros((8192, 4)), 0)


def test_chunked_one_chunk_is_plain_frame(clouds, single):
    """num_chunks=1 is the plain frame (the fused engine, so K1 on the
    card), not a chunked one."""
    fn = make_chunked_frame_fn(Params(), 1, device="cpu")
    assert hasattr(fn, "fit_inputs")  # the plain fused frame's
    c = clouds[0]
    _, res = fn(init_state(Params(), device="cpu"), torch.from_numpy(_padded(c)), len(c))
    for f in res._fields:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      getattr(single[0][1], f).numpy(), err_msg=f)


def test_default_device_is_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_chunked_frame_fn(Params(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PatchworkPP(chunks=2)
