"""Port binning and tiled layout vs the JAX package on seeded synthetic
clouds (tests/test_fuzz_parity.py:synth_cloud) at capacity 8192.

Integer outputs must be equal: patch ids, flags, rings, sectors, counts,
the tile layout. The one freedom is the order of rows with bit-identical
(patch, z) sort keys (the JAX sort is unstable, the port's is stable), so
the tiled x/y rows are compared as a multiset within such ties.

The boundary-probe variant (``exact_edges=True``) puts points within an
ulp of ring, sector and RNR edges. The port rounds each binning step as
XLA:CPU does, so even there every output must be equal: r^2 is XLA's
contracted ``fma(x, x, y*y)`` (``ops.sq_sum``), a division by a constant is
a multiply by its float32 reciprocal (``ops.div``), and both angles are
glibc's ``atan2f`` (``ops/trig.py:atan2_f32``), which these tests hold bit
for bit against ``jnp.arctan2`` and glibc itself. ``torch.atan2`` is not
that function (PyTorch's CPU build computes float32 atan2 another way; the
test prints on how many points it differs), so the port does not call it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu.ops.binning import bin_points as j_bin_points
from patchworkpp_tpu.ops.binning import factored_patch_counts as j_counts
from patchworkpp_tpu.ops.tiled import build_tiled as j_build_tiled
from patchworkpp_tpu.params import CZMGeometry as JGeom
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu_torch.ops import div, sq_sum, sqrt
from patchworkpp_tpu_torch.ops.binning import bin_points, factored_patch_counts
from patchworkpp_tpu_torch.ops.trig import atan2_f32
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


@pytest.mark.parametrize("seed", range(5))
def test_edge_probe_disagreements_are_boundary_points(jax_bins, seed):
    """No disagreement is left, boundary point or not: every binning output
    equals the JAX package's on the edge probes of three clouds a seed
    (seed, seed + 5, seed + 10: the 15 clouds of test_torch_frame.py)."""
    for k in range(3):
        _, jb, tb = _both(jax_bins, synth_cloud(seed + 5 * k, exact_edges=True))
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                err_msg=f"cloud {seed + 5 * k} {f}",
            )


def _edge_angles():
    """Both atan2 argument pairs of the binning, (y, x) and (z, r), over
    every point of synth_cloud(0..14, exact_edges=True)."""
    ys, xs = [], []
    for seed in range(15):
        c = synth_cloud(seed, exact_edges=True)
        r = sqrt(sq_sum(torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1]))).numpy()
        ys += [c[:, 1], c[:, 2]]
        xs += [c[:, 0], r]
    return np.concatenate(ys), np.concatenate(xs)


def _random_angles():
    """200k seeded points over |x|, |y| <= 100, plus ratios y/x swept over
    atanf's reduction intervals, their edges and both quadrant sides."""
    rng = np.random.default_rng(7)
    y = rng.uniform(-100, 100, 200_000).astype(np.float32)
    x = rng.uniform(-100, 100, 200_000).astype(np.float32)
    t = np.geomspace(1e-12, 1e12, 20_000).astype(np.float32)
    t = np.concatenate([t, np.float32([7 / 16, 11 / 16, 19 / 16, 39 / 16, 2**25])])
    t = np.concatenate([t, np.nextafter(t, np.float32(0)),
                        np.nextafter(t, np.float32(np.inf))])
    sgn = np.where(rng.uniform(size=t.shape) < 0.5, -1, 1).astype(np.float32)
    return (np.concatenate([y, sgn * t, -t]),
            np.concatenate([x, np.ones_like(t), np.full_like(t, -3.0)]))


def _special_angles(subnormals: bool):
    """Axes, signed zeros, infinities and NaN against each other and
    against ordinary values (and, with ``subnormals``, subnormal ones)."""
    v = [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 0.5, 3.0, 1e-30, 1e30, 2.0**26]
    if subnormals:
        v += [1e-45, -1e-45, 3e-39]
    v = np.float32(v + [np.nan])
    yy, xx = np.meshgrid(v, v)
    return yy.ravel(), xx.ravel()


def _bits_equal(a, b):
    """Bitwise equality, with any NaN equal to any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("inputs", ["edge_clouds", "random", "special"])
def test_atan2_f32_bitwise_equal_to_jnp_arctan2(inputs):
    y, x = {"edge_clouds": _edge_angles, "random": _random_angles,
            "special": lambda: _special_angles(False)}[inputs]()
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ok = _bits_equal(got, want)
    assert ok.all(), (y[~ok][:5], x[~ok][:5], got[~ok][:5], want[~ok][:5])
    other = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    print(f"{inputs}: {len(y)} points bitwise equal; torch.atan2 differs "
          f"on {int((~_bits_equal(other, want)).sum())}")


SUBNORMAL_GRID_VALUES = (
    0.0, -0.0, 1.0, -1.0, 0.5, 3.0, 5.0, -5.0, 7.0, 20.0, -20.0, 1e-30,
    1e-45, -1e-45, 3e-39, -3e-39, 1e-40, -1e-40, 1.1754942e-38,
    -1.1754942e-38, 2.0**-126, 1e-38, 4e-38,
)
SUBNORMAL_GRID_Z = (-1.7, 1e-40, -3e-39, -2.6)


def subnormal_grid() -> np.ndarray:
    """Every (x, y) pair of 23 values (zeros, ordinary, subnormal and
    smallest-normal coordinates) at 4 z values: 2,116 points, intensity 0.1
    (under the RNR threshold, so the z = -2.6 rows meet RNR's angle test)."""
    v = np.float32(SUBNORMAL_GRID_VALUES)
    xx, yy, zz = np.meshgrid(v, v, np.float32(SUBNORMAL_GRID_Z), indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel(),
                     np.full(xx.size, 0.1, np.float32)], 1)


def test_subnormal_coordinates_bin_as_jax():
    """XLA:CPU flushes a subnormal atan2 result to zero; the port flushes
    the results of its two atan2_f32 calls (not their operands), so every
    output equals the JAX package's, e.g. (3, 3e-39) wraps to sector 15."""
    cloud = subnormal_grid()
    assert len(cloud) == 2116
    cap = 4096
    pts = np.zeros((cap, 4), np.float32)
    pts[: len(cloud)] = cloud
    jp = JParams()
    jb = jax.jit(lambda a, n, sh: j_bin_points(a, n, sh, jp, JGeom.create(jp)))(
        jnp.asarray(pts), jnp.int32(len(cloud)), jnp.float32(SH))
    p = Params()
    tb = bin_points(torch.from_numpy(pts), len(cloud), torch.tensor(SH), p,
                    CZMGeometry.create(p))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    i = np.flatnonzero((cloud[:, 0] == 3.0) & (cloud[:, 1] == np.float32(3e-39))
                       & (cloud[:, 2] == np.float32(-1.7)))[0]
    assert int(tb.sector[i]) == p.num_sectors_each_zone[0] - 1


def test_atan2_f32_equals_glibc_atan2f_with_subnormals():
    """glibc's own atan2f through ctypes, subnormal inputs included (XLA
    flushes those to zero; the port, like glibc, keeps them)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.atan2f.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    y, x = _special_angles(True)
    ry, rx = _random_angles()
    y, x = np.concatenate([y, ry[::50]]), np.concatenate([x, rx[::50]])
    want = np.float32([libm.atan2f(float(a), float(b)) for a, b in zip(y, x)])
    got = atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ok = _bits_equal(got, want)
    assert ok.all(), (y[~ok][:5], x[~ok][:5], got[~ok][:5], want[~ok][:5])


def test_r_squared_and_division_round_as_xla():
    """r^2 = fma(x, x, y*y) correctly rounded, its root, and a division by
    a constant, bitwise against the jitted JAX expressions (XLA:CPU
    contracts the first and turns the last into a reciprocal multiply)."""
    ye, xe = _edge_angles()
    rng = np.random.default_rng(3)
    x = np.concatenate([xe, rng.uniform(-100, 100, 300_000)]).astype(np.float32)
    y = np.concatenate([ye, rng.uniform(-100, 100, 300_000)]).astype(np.float32)
    jr2, jr, jdiv = jax.jit(lambda x, y: (x * x + y * y, jnp.sqrt(x * x + y * y),
                                          x / jnp.float32(0.3)))(x, y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    r2 = sq_sum(tx, ty)
    np.testing.assert_array_equal(r2.numpy().view(np.int32), np.asarray(jr2).view(np.int32))
    np.testing.assert_array_equal(sqrt(r2).numpy(), np.asarray(jr))
    np.testing.assert_array_equal(div(tx, 0.3).numpy(), np.asarray(jdiv))
    # the plain float32 expressions are not XLA's
    assert ((tx * tx + ty * ty).numpy() != np.asarray(jr2)).any()
    assert ((tx / 0.3).numpy() != np.asarray(jdiv)).any()


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
