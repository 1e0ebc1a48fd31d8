"""The frame's comm hooks (pipeline.FrameComm and
parallel/point_sharded.MeshComm) against the JAX package's.

- The identity comm, passed explicitly, gives the default frame's bits on
  every engine (every FrameResult field and the state).
- FrameComm.merge_lpr_table holds the JAX contract (tests/test_sharded.py::
  test_merge_lpr_table_contract) and equals the JAX identity bit for bit.
- MeshComm.merge_lpr_table, over K shards that meet in chunk threads,
  equals the JAX MeshComm's (run under jax.vmap with an axis name) bit for
  bit on random tables with +inf slots, ties inside and across shards,
  empty patches and counts past num_lpr: the same sorted candidates, the
  same sum order.
- MeshComm.reduce_patches is the left-to-right chain over the shards.
- The kernel modes raise under a sharded comm, in the JAX package's words.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu.parallel.point_sharded import MeshComm as JMeshComm
from patchworkpp_tpu.pipeline import FrameComm as JFrameComm
from patchworkpp_tpu_torch import Params, init_state
from patchworkpp_tpu_torch.parallel.chunked import ChunkTransport, Exchange, run_chunks
from patchworkpp_tpu_torch.parallel.point_sharded import MeshComm
from patchworkpp_tpu_torch.pipeline import FrameComm, make_frame_fn
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import _one_torch_thread  # noqa: F401

NUM_LPR = 20


def _padded(cloud):
    pts = np.zeros((CAP, 4), np.float32)
    pts[: len(cloud)] = cloud
    return torch.from_numpy(pts)


def _assert_same(a, b, label):
    (sa, ra), (sb, rb) = a, b
    for f in ra._fields:
        np.testing.assert_array_equal(getattr(ra, f).numpy(), getattr(rb, f).numpy(),
                                      err_msg=f"{label} {f}")
    na, nb = sa.to_numpy(), sb.to_numpy()
    for k in na:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=f"{label} state {k}")


@pytest.mark.parametrize("fused", [None, "onehot", False])
def test_identity_comm_keeps_every_bit(fused):
    p = Params()
    plain = make_frame_fn(p, device="cpu", fused=fused)
    ident = make_frame_fn(p, device="cpu", fused=fused, comm=FrameComm())
    sa = sb = init_state(p, device="cpu")
    for k in range(2):
        cloud = synth_cloud(3 + 5 * k, exact_edges=False)
        a = plain(sa, _padded(cloud), len(cloud))
        b = ident(sb, _padded(cloud), len(cloud))
        _assert_same(a, b, f"fused={fused!r} frame {k}")
        (sa, _), (sb, _) = a, b


def _random_tables(seed: int, shards: int, spad: int = 64):
    """Per-shard (z, occ, count) tables: z drawn from a few values (ties in
    and across shards) and wide scales, occupied slots a prefix of each
    row (as the tiled engine fills them, ascending), counts >= the
    occupied slots and sometimes past num_lpr, some rows empty."""
    rng = np.random.default_rng(seed)
    pool = (rng.standard_normal(12) * rng.choice([1e-3, 1.0, 30.0], 12)).astype(np.float32)
    z = np.sort(rng.choice(pool, (shards, spad, NUM_LPR)), axis=2).astype(np.float32)
    filled = rng.integers(0, NUM_LPR + 1, (shards, spad))
    filled[:, :3] = 0  # empty patches
    occ = (np.arange(NUM_LPR)[None, None, :] < filled[..., None]).astype(np.float32)
    z = np.where(occ > 0.5, z, np.float32(0.0))
    extra = rng.integers(0, 30, (shards, spad)) * (filled == NUM_LPR)
    cnt = (filled + extra).astype(np.float32)
    return z, occ, cnt


def _port_merge(z, occ, cnt):
    """Shard 0's (lpr_sum, lpr_cnt) from the port's MeshComm, the shards
    meeting in chunk threads."""
    shards = z.shape[0]
    ex = Exchange(shards)
    comms = [MeshComm(ChunkTransport(ex, i)) for i in range(shards)]
    outs = run_chunks(ex, [
        (lambda i=i: comms[i].merge_lpr_table(
            torch.from_numpy(z[i]), torch.from_numpy(occ[i]),
            torch.from_numpy(cnt[i]), NUM_LPR))
        for i in range(shards)
    ])
    for s, k in outs[1:]:  # every shard holds the same merge
        assert torch.equal(s, outs[0][0]) and torch.equal(k, outs[0][1])
    return outs[0]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_merge_lpr_table_equals_jax_bitwise(shards, seed):
    z, occ, cnt = _random_tables(seed, shards)
    jfn = jax.jit(jax.vmap(
        lambda a, b, c: JMeshComm("c").merge_lpr_table(a, b, c, NUM_LPR), axis_name="c"))
    js, jk = jfn(jnp.asarray(z), jnp.asarray(occ), jnp.asarray(cnt))
    s, k = _port_merge(z, occ, cnt)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk)[0])
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js)[0].view(np.int32))
    assert (k.numpy() == np.minimum(cnt.sum(0), NUM_LPR)).all()


def test_identity_merge_lpr_table_contract():
    """The JAX contract's table (occupied slots in rank order, the count
    clamped to num_lpr, an empty patch (0, 0)), and the JAX identity's bits
    on a random table."""
    z = np.asarray([[-1.9, -1.7, -1.5, 0.0], [-2.0, -1.8, -1.6, -1.4],
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    occ = np.asarray([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], np.float32)
    cnt = np.asarray([3.0, 9.0, 0.0], np.float32)
    s, k = FrameComm().merge_lpr_table(*map(torch.from_numpy, (z, occ, cnt)), 4)
    np.testing.assert_allclose(s.numpy(), [-5.1, -6.8, 0.0], rtol=1e-6)
    np.testing.assert_array_equal(k.numpy(), [3.0, 4.0, 0.0])
    zr, occr, cntr = (a[0] for a in _random_tables(7, 1))
    js, jk = JFrameComm().merge_lpr_table(jnp.asarray(zr), jnp.asarray(occr),
                                          jnp.asarray(cntr), NUM_LPR)
    s, k = FrameComm().merge_lpr_table(*map(torch.from_numpy, (zr, occr, cntr)), NUM_LPR)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


def test_reduce_patches_is_the_shard_order_chain():
    rng = np.random.default_rng(0)
    parts = (rng.standard_normal((4, 64, 10)) * 1e3).astype(np.float32)
    ex = Exchange(4)
    comms = [MeshComm(ChunkTransport(ex, i)) for i in range(4)]
    outs = run_chunks(ex, [(lambda i=i: comms[i].reduce_patches(torch.from_numpy(parts[i])))
                           for i in range(4)])
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), want)
    assert [c.row_offset(1024) for c in comms] == [0, 1024, 2048, 3072]


@pytest.mark.parametrize("fused", [True, "grid", "grid_iota", "onehot"])
def test_kernel_modes_raise_under_a_sharded_comm(fused):
    comm = MeshComm(ChunkTransport(Exchange(2), 0))
    with pytest.raises(ValueError, match="cannot run under a point-sharded comm"):
        make_frame_fn(Params(), device="cpu", fused=fused, comm=comm)
    for ok in ("tiled", None, False):
        make_frame_fn(Params(), device="cpu", fused=ok, comm=comm)
