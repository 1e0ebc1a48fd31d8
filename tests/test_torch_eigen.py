"""Port eigensolver and trig polynomials vs the JAX package (CPU).

The port repeats the JAX expressions term by term and rounds them as
XLA:CPU's compiled function does, fused multiply-adds included
(ops/eigen3.py), so the eigenvalues, the polynomials and the separated
pair's normal are the JAX function's bits. A clustered pair's normal is
not: XLA:CPU computes its ``1 / sqrt`` from the CPU's reciprocal
square-root estimate and two Newton steps, the port the correctly rounded
value. There the normal agrees to the deflation's error class, ~6e-4 rad,
with both packages ~5e-4 rad from the float64 truth; the angles are
printed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchworkpp_tpu.ops import trig as jtrig
from patchworkpp_tpu.ops.eigen3 import eig3_plane_columns as j_eig
from patchworkpp_tpu.ops.eigen3 import eigh3x3_descending as j_eigh
from patchworkpp_tpu_torch.ops import trig as ttrig
from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns as t_eig
from patchworkpp_tpu_torch.ops.eigen3 import eigh3x3_descending as t_eigh

EPS32 = float(np.finfo(np.float32).eps)


def _psd(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3)) * rng.uniform(0.01, 3.0, (n, 1, 1))
    return (a @ a.transpose(0, 2, 1)).astype(np.float32)


def _clustered(seed, n=2048):
    """A large eigenvalue over a close small pair, like the measured
    near-collinear patch {5.85, 0.0100, 0.0082} (JAX eigen3 docstring)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    ev = np.stack(
        [rng.uniform(1, 10, n), np.full(n, 0.0100), rng.uniform(0.0080, 0.0095, n)], 1
    )
    return ((q * ev[:, None, :]) @ q.transpose(0, 2, 1)).astype(np.float32)


def _cols(c):
    return [np.ascontiguousarray(c[:, i, j]) for i, j in
            ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]


@pytest.mark.parametrize("kind,seed", [("psd", 0), ("psd", 1), ("clustered", 2)])
def test_eig3_plane_columns_matches_jax(kind, seed):
    c = _psd(seed) if kind == "psd" else _clustered(seed)
    cols = _cols(c)
    j = [np.asarray(x) for x in jax.jit(j_eig)(*map(jnp.asarray, cols))]
    t = [x.numpy() for x in t_eig(*map(torch.from_numpy, cols))]

    for i in range(3):  # eigenvalues: the JAX function's bits
        np.testing.assert_array_equal(t[i].view(np.int32), j[i].view(np.int32))
    w, v = np.linalg.eigh(c.astype(np.float64))
    fro = np.linalg.norm(c.astype(np.float64), axis=(1, 2))
    np.testing.assert_array_less(np.abs(t[0] - w[:, 2]), 32 * EPS32 * fro + 1e-30)

    def angle(a, b):
        return np.arccos(np.clip(np.abs(np.sum(a * b, axis=1)), 0.0, 1.0))

    # the normal: bit for bit where the pair is clearly separated (the
    # solver's test is e1 - e2 > 1e-2 * ||A||_F); a clustered pair's within
    # 2e-3 rad of JAX and 1e-3 rad of float64
    clustered = (j[1] - j[2]) <= 1.02e-2 * fro
    vj = np.stack(j[3:], 1)
    vt = np.stack(t[3:], 1)
    assert (~clustered).sum() > 3000 if kind == "psd" else clustered.all()
    np.testing.assert_array_equal(vt[~clustered], vj[~clustered])
    ang = angle(vj.astype(np.float64), vt.astype(np.float64))
    ang_true = angle(vt.astype(np.float64), v[:, :, 0])
    print(f"{kind} vmin: {int(clustered.sum())} clustered, max angle {ang.max():.3e} rad "
          f"to JAX, {ang_true.max():.3e} rad to float64")
    assert ang.max() < 2e-3 and ang_true.max() < 1e-3


def test_eigh3x3_descending_sign_and_order():
    c = _psd(3, 512)
    ej, vj = (np.asarray(x) for x in jax.jit(j_eigh)(jnp.asarray(c)))
    et, vt = (x.numpy() for x in t_eigh(torch.from_numpy(c)))
    assert (vt[:, 2] >= 0).all()
    assert (et[:, 0] >= et[:, 1]).all() and (et[:, 1] >= et[:, 2] - 1e-6).all()
    np.testing.assert_array_equal(et, ej)
    cols = [torch.from_numpy(x) for x in _cols(c)]
    values = torch.stack(t_eig(*cols, vector=False), dim=-1).numpy()
    np.testing.assert_array_equal(values, et)


def test_eig_nan_and_degenerate_inputs():
    nan = np.float32(np.nan)
    cols = [np.array([nan, 0.0, 1.0], np.float32)] + [
        np.array([0.0, 0.0, 0.0], np.float32) for _ in range(5)
    ]
    cols[3] = np.array([1.0, 0.0, 1.0], np.float32)
    cols[5] = np.array([1.0, 0.0, 1.0], np.float32)
    out = [x.numpy() for x in t_eig(*map(torch.from_numpy, cols))]
    ref = [np.asarray(x) for x in jax.jit(j_eig)(*map(jnp.asarray, cols))]
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.isnan(out[3][0])                      # NaN input -> NaN vector
    np.testing.assert_array_equal(out[5][1:], [1.0, 1.0])  # degenerate -> +z


def test_trig_polynomials_match_jax():
    r = np.linspace(-1.0, 1.0, 20001, dtype=np.float32)
    phi = np.linspace(0.0, np.pi / 3, 20001, dtype=np.float32)
    pairs = [
        (jtrig.acos_poly, ttrig.acos_poly, r),
        (jtrig.sin_narrow, ttrig.sin_narrow, phi),
        (jtrig.cos_narrow, ttrig.cos_narrow, phi),
        (lambda x: jtrig.cardano_cos_pair(x)[1], lambda x: ttrig.cardano_cos_pair(x)[1], r),
    ]
    for jf, tf, x in pairs:
        a = np.asarray(jax.jit(jf)(jnp.asarray(x)))
        b = tf(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))
