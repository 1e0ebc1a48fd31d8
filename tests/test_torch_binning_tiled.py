"""Port binning and tiled layout vs the JAX package on seeded synthetic
clouds (tests/test_fuzz_parity.py:synth_cloud) at capacity 8192.

Integer outputs must be equal: patch ids, flags, rings, sectors, counts,
the tile layout. The one freedom is the order of rows with bit-identical
(patch, z) sort keys (the JAX sort is unstable, the port's is stable), so
the tiled x/y rows are compared as a multiset within such ties.

On the boundary-probe variant (``exact_edges=True``) some points have no
f32-decidable bin: the port's float64 atan2 and XLA's float32 atan2 / sqrt
may round them to opposite sides (ops/binning.py, JAX binning.py:97-106).
Those are reported, and the test asserts that every disagreement is such a
boundary point.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchworkpp_tpu.ops.binning import bin_points as j_bin_points
from patchworkpp_tpu.ops.binning import factored_patch_counts as j_counts
from patchworkpp_tpu.ops.tiled import build_tiled as j_build_tiled
from patchworkpp_tpu.params import CZMGeometry as JGeom
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu_torch.ops.binning import bin_points, factored_patch_counts
from patchworkpp_tpu_torch.ops.segments import z_sort_key, z_sort_key_inverse
from patchworkpp_tpu_torch.ops.tiled import build_tiled, tiled_capacity
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from test_fuzz_parity import CAP, synth_cloud

FIELDS = ("patch_id", "valid", "noise", "in_range", "ring14", "sector")
SH = np.float32(1.723)


@pytest.fixture(scope="module")
def jax_bins():
    p = JParams()
    geom = JGeom.create(p)
    fn = jax.jit(
        lambda pts, n, sh: j_bin_points(pts, n, sh, p, geom)
    )
    return p, geom, fn


def _padded(cloud):
    pts = np.zeros((CAP, 4), np.float32)
    pts[: len(cloud)] = cloud
    return pts


def _both(jax_bins, cloud):
    _, jgeom, fn = jax_bins
    pts = _padded(cloud)
    jb = fn(jnp.asarray(pts), jnp.int32(len(cloud)), jnp.float32(SH))
    p = Params()
    tb = bin_points(torch.from_numpy(pts), len(cloud), torch.tensor(SH), p,
                    CZMGeometry.create(p))
    return pts, jb, tb


@pytest.mark.parametrize("seed", range(5))
def test_bins_and_counts_equal(jax_bins, seed):
    _, jgeom, _ = jax_bins
    pts, jb, tb = _both(jax_bins, synth_cloud(seed, exact_edges=False))
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jb, f)), getattr(tb, f).numpy(), err_msg=f
        )
    np.testing.assert_array_equal(
        np.asarray(j_counts(jb, jgeom, jgeom.spad)),
        factored_patch_counts(tb, CZMGeometry.create(Params())).numpy(),
    )


def _near_boundary(pts, p: Params, geom: CZMGeometry):
    """Rows within a hair of a ring/zone edge, a sector edge or the RNR
    vertical-angle gate, evaluated in float64."""
    x, y, z = (pts[:, i].astype(np.float64) for i in range(3))
    r = np.hypot(x, y)
    near = np.zeros(len(pts), bool)
    for k in range(p.num_zones):
        for j in range(p.num_rings_each_zone[k] + 1):
            e = geom.min_ranges[k] + j * geom.ring_sizes[k]
            near |= np.abs(r - e) <= 1e-5 * e
    th = np.mod(np.arctan2(y, x), 2 * np.pi)
    for k in range(p.num_zones):
        s = geom.sector_sizes[k]
        frac = th / s
        near |= np.abs(frac - np.round(frac)) * s <= 1e-5
    ver = np.degrees(np.arctan2(z, r))
    near |= np.abs(ver - p.RNR_ver_angle_thr) <= 1e-4
    return near


@pytest.mark.parametrize("seed", range(5))
def test_edge_probe_disagreements_are_boundary_points(jax_bins, seed):
    cloud = synth_cloud(seed, exact_edges=True)
    pts, jb, tb = _both(jax_bins, cloud)
    n = len(cloud)
    diff = np.zeros(n, bool)
    for f in FIELDS:
        diff |= np.asarray(getattr(jb, f))[:n] != getattr(tb, f).numpy()[:n]
    near = _near_boundary(cloud, Params(), CZMGeometry.create(Params()))
    print(f"seed {seed}: {int(diff.sum())} boundary straddler(s) "
          f"among {int(near.sum())} boundary points")
    assert not (diff & ~near).any(), np.flatnonzero(diff & ~near)


def test_z_sort_key_roundtrip_and_order():
    rng = np.random.default_rng(0)
    z = np.concatenate([
        rng.normal(size=1000) * np.exp(rng.uniform(-20, 20, 1000)),
        [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40],
    ]).astype(np.float32)
    k = z_sort_key(torch.from_numpy(z))
    assert int(k.min()) >= 0 and int(k.max()) < 2**32
    back = z_sort_key_inverse(k).numpy()
    np.testing.assert_array_equal(back.view(np.int32), z.view(np.int32))
    order = np.argsort(k.numpy(), kind="stable")
    assert (np.diff(z[order].astype(np.float64)) >= 0).all()


@pytest.mark.parametrize("seed", range(5))
def test_tiled_layout_equal(jax_bins, seed):
    _, jgeom, _ = jax_bins
    pts, jb, tb = _both(jax_bins, synth_cloud(seed, exact_edges=False))
    spad = jgeom.spad
    jt = jax.jit(j_build_tiled, static_argnames="width")(
        jnp.asarray(pts[:, :3]), jb.patch_id,
        counts=j_counts(jb, jgeom, spad), width=spad,
    )
    tt = build_tiled(
        torch.from_numpy(pts[:, :3]), tb.patch_id,
        counts=factored_patch_counts(tb, CZMGeometry.create(Params())),
        width=spad,
    )
    assert tt.xyz.shape[0] == tiled_capacity(CAP, spad)
    for f in ("tile_patch", "valid", "counts", "pad_start", "patch_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, f)), getattr(tt, f).numpy(), err_msg=f
        )
    jx, tx = np.asarray(jt.xyz), tt.xyz.numpy()
    # the sort keys (patch, z) sit in the same order ...
    np.testing.assert_array_equal(jx[:, 2], tx[:, 2])
    # ... and the rows are the same up to the order of tied keys
    pid = tt.patch_id.numpy()
    oj = np.lexsort((jx[:, 1], jx[:, 0], jx[:, 2], pid))
    ot = np.lexsort((tx[:, 1], tx[:, 0], tx[:, 2], pid))
    np.testing.assert_array_equal(jx[oj], tx[ot])
    assert math.isclose(float(tt.counts.sum()), CAP)
