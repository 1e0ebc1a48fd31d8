"""Batched symmetric 3x3 eigensolver: Cardano + clustered-pair deflation.

Port of ``patchworkpp_tpu/ops/eigen3.py``, written term by term after the
JAX expressions (see that module for the derivation and the measured
reason for the hybrid vector construction). The CUDA fit kernels
(csrc/fit_math.cuh ``eig3_plane``) repeat the same operation sequence, so
the plain and kernel paths resolve every eigenproblem to the same bits.

Rounding follows XLA:CPU's compiled JAX function. Its x86 backend fuses a
multiply into the add or subtract that uses it (``ops.fma``) when the
product has no other use inside the fusion: ``a*b + c*d`` becomes
``fma(a, b, c*d)`` (the left product first), ``a - b*c`` becomes
``fma(-b, c, a)``; a product shared by two expressions of one fusion is
rounded on its own. XLA also folds ``3 * (t * 1/3)`` to ``t``. The
choices below were read from the compiled fusions (``XLA_FLAGS=
--xla_dump_to``: the fusion HLO for the shared products, ``objdump -d`` of
the fusion objects for the ``vfmadd``/``vfmsub`` forms) and hold the
eigenvalues and the separated-pair vector to the JAX function's bits.
Where one value is computed in two fusions with different sharing, each
consumer gets its own rounding (``e2`` and ``fro2`` of the separated pair).

Not mirrored: XLA:CPU computes the clustered branch's ``1 / sqrt(x)`` as
the CPU's reciprocal square-root estimate refined by two Newton steps, whose
last bit depends on the host's estimate table; this module keeps the
correctly rounded ``1 / sqrt``, so a clustered pair's normal may differ
from the JAX package's in the last bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from patchworkpp_tpu_torch.ops import div, f32, fma, sqrt
from patchworkpp_tpu_torch.ops.trig import cardano_cos_pair

_EPS = f32(1e-12)
_TINY = f32(1e-30)
_REL = f32(1e-12)
_CLUSTER_REL_GAP = f32(1e-2)


def _cross3(px, py, pz, qx, qy, qz):
    return (
        py * qz - pz * qy,
        pz * qx - px * qz,
        px * qy - py * qx,
    )


def _best_row_cross(d00, a01, a02, d11, a12, d22, contracted=False):
    """Largest cross product of two rows of a symmetric matrix.
    Returns (vx, vy, vz, nbest).

    ``contracted``: the rounding of the fusion that builds the separated
    pair's vector. There the products a01*a02, d00*a12, a01*d22 and
    a02*a12 each serve two components (a row pair's cross products share
    them), and a01^2, a02^2, a12^2 also serve off_sq, so only the other
    products fuse into their subtraction; the squared norms fuse their
    single-use squares, ax*ax (= cz*cz) serving two."""
    if not contracted:
        ax, ay, az = _cross3(d00, a01, a02, a01, d11, a12)
        bx, by, bz = _cross3(d00, a01, a02, a02, a12, d22)
        cx, cy, cz = _cross3(a01, d11, a12, a02, a12, d22)
        na = ax * ax + ay * ay + az * az
        nb = bx * bx + by * by + bz * bz
        nc = cx * cx + cy * cy + cz * cz
    else:
        ax = fma(a01, a12, -(a02 * d11))
        ay = a02 * a01 - d00 * a12
        az = fma(d00, d11, -(a01 * a01))
        bx = a01 * d22 - a02 * a12
        by = fma(-d00, d22, a02 * a02)
        bz = d00 * a12 - a01 * a02
        cx = fma(d11, d22, -(a12 * a12))
        cy = a12 * a02 - a01 * d22
        cz = ax  # a01*a12 - d11*a02: the same products, the same bits
        na = fma(az, az, fma(ay, ay, ax * ax))
        nb = fma(bz, bz, fma(bx, bx, by * by))
        nc = fma(cx, cx, cy * cy) + cz * cz
    use_a = na >= nb
    vx = torch.where(use_a, ax, bx)
    vy = torch.where(use_a, ay, by)
    vz = torch.where(use_a, az, bz)
    nab = torch.maximum(na, nb)
    use_ab = nab >= nc
    vx = torch.where(use_ab, vx, cx)
    vy = torch.where(use_ab, vy, cy)
    vz = torch.where(use_ab, vz, cz)
    return vx, vy, vz, torch.maximum(nab, nc)


def eig3_plane_columns(a00, a01, a02, a11, a12, a22, vector=True):
    """Eigenvalues (descending) and the UNFLIPPED unit eigenvector of the
    smallest one, for batches of symmetric 3x3 matrices given by their six
    distinct entries (same-shape float32 tensors).

    Returns (e0, e1, e2, vx, vy, vz), or (e0, e1, e2) when not ``vector``
    (XLA drops the unused vector's ops the same way). Degenerate pencils
    resolve to +z; non-finite input gives NaN outputs."""
    off_sq = fma(a12, a12, fma(a01, a01, a02 * a02))
    diag_sq = fma(a22, a22, fma(a00, a00, a11 * a11))
    fro2 = diag_sq + 2.0 * off_sq
    tr = a00 + a11 + a22
    third = f32(1.0 / 3.0)
    q = tr * third  # ops.div(tr, 3.0)
    # b = a - q, with q's product fused into the subtraction
    b00, b11, b22 = (fma(-tr, third, a) for a in (a00, a11, a22))
    p2 = fma(b22, b22, fma(b00, b00, b11 * b11)) + 2.0 * off_sq
    p = sqrt(div(p2, 6.0))

    safe_p = torch.where(p > _EPS, p, torch.ones_like(p))
    c00, c11, c22 = b00 / safe_p, b11 / safe_p, b22 / safe_p
    c01, c02, c12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = fma(
        c02, fma(c01, c12, -(c11 * c02)),
        fma(c00, fma(c11, c22, -(c12 * c12)), -(c01 * fma(c01, c22, -(c12 * c02)))),
    )
    r = torch.clamp(div(detb, 2.0), -1.0, 1.0)
    cos_lo, cos_hi = cardano_cos_pair(r)

    two_p = 2.0 * p
    e0 = fma(two_p, cos_lo, q)
    e2 = fma(two_p, cos_hi, q)
    e1 = (tr - e0) - e2  # 3 * q, folded to the trace

    isotropic = p2 <= _EPS
    e0v = torch.where(isotropic, q, e0)
    e1v = torch.where(isotropic, q, e1)
    e2v = torch.where(isotropic, q, e2)
    bad = ~torch.isfinite(a00 + a11 + a22 + off_sq)
    nan = torch.full_like(a00, float("nan"))
    if not vector:
        return tuple(torch.where(bad, nan, t) for t in (e0v, e1v, e2v))

    zero = torch.zeros_like(a00)
    one = torch.ones_like(a00)

    # separated pair: eigenvector of e2 from the largest row cross product.
    # Its fusion holds q once, so e2 there fuses q's product instead, and
    # its off_sq squares are shared with the cross products (no fusing).
    e2s = fma(tr, third, two_p * cos_hi)
    sx, sy, sz, nbest_s = _best_row_cross(
        a00 - e2s, a01, a02, a11 - e2s, a12, a22 - e2s, contracted=True
    )
    fro2_s = diag_sq + 2.0 * ((a01 * a01 + a02 * a02) + a12 * a12)
    degen_s = nbest_s <= _REL * fro2_s * fro2_s
    sx = torch.where(degen_s, zero, sx)
    sy = torch.where(degen_s, zero, sy)
    sz = torch.where(degen_s, one, sz)
    norm_s = sqrt(fma(sz, sz, fma(sx, sx, sy * sy)))
    sx, sy, sz = sx / norm_s, sy / norm_s, sz / norm_s

    # clustered pair: deflation from the isolated largest root
    vx0, vy0, vz0, nbest0 = _best_row_cross(
        a00 - e0, a01, a02, a11 - e0, a12, a22 - e0
    )
    degen0 = nbest0 <= _REL * fro2 * fro2
    inv0 = 1.0 / sqrt(torch.clamp_min(nbest0, _TINY))
    vx0, vy0, vz0 = vx0 * inv0, vy0 * inv0, vz0 * inv0

    nux = vy0 * vy0 + vz0 * vz0
    nuy = vx0 * vx0 + vz0 * vz0
    use_x = nux >= nuy
    u1x = torch.where(use_x, zero, -vz0)
    u1y = torch.where(use_x, vz0, zero)
    u1z = torch.where(use_x, -vy0, vx0)
    inv1 = 1.0 / sqrt(torch.clamp_min(torch.maximum(nux, nuy), _TINY))
    u1x, u1y, u1z = u1x * inv1, u1y * inv1, u1z * inv1
    u2x, u2y, u2z = _cross3(vx0, vy0, vz0, u1x, u1y, u1z)

    w1x = a00 * u1x + a01 * u1y + a02 * u1z
    w1y = a01 * u1x + a11 * u1y + a12 * u1z
    w1z = a02 * u1x + a12 * u1y + a22 * u1z
    w2x = a00 * u2x + a01 * u2y + a02 * u2z
    w2y = a01 * u2x + a11 * u2y + a12 * u2z
    w2z = a02 * u2x + a12 * u2y + a22 * u2z
    t11 = u1x * w1x + u1y * w1y + u1z * w1z
    t12 = u1x * w2x + u1y * w2y + u1z * w2z
    t22 = u2x * w2x + u2y * w2y + u2z * w2z

    mean2 = 0.5 * (t11 + t22)
    dd = 0.5 * (t11 - t22)
    s2x2 = sqrt(dd * dd + t12 * t12)
    lam = mean2 - s2x2
    ca1, ca2 = t12, lam - t11
    cb1, cb2 = lam - t22, t12
    na2 = ca1 * ca1 + ca2 * ca2
    nb2 = cb1 * cb1 + cb2 * cb2
    use_ca = na2 >= nb2
    g1 = torch.where(use_ca, ca1, cb1)
    g2 = torch.where(use_ca, ca2, cb2)
    wn2 = torch.maximum(na2, nb2)
    degen2 = wn2 <= _REL * fro2
    invw = 1.0 / sqrt(torch.clamp_min(wn2, _TINY))
    g1, g2 = g1 * invw, g2 * invw

    dx = g1 * u1x + g2 * u2x
    dy = g1 * u1y + g2 * u2y
    dz = g1 * u1z + g2 * u2z
    invn = 1.0 / sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz, _TINY))
    dx, dy, dz = dx * invn, dy * invn, dz * invn

    degen_d = degen0 | degen2
    dx = torch.where(degen_d, zero, dx)
    dy = torch.where(degen_d, zero, dy)
    dz = torch.where(degen_d, one, dz)

    fro = sqrt(fro2)
    clustered = (e1 - e2) <= _CLUSTER_REL_GAP * fro
    vx = torch.where(clustered, dx, sx)
    vy = torch.where(clustered, dy, sy)
    vz = torch.where(clustered, dz, sz)

    return tuple(
        torch.where(bad, nan, t) for t in (e0v, e1v, e2v, vx, vy, vz)
    )


def eigh3x3_descending(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3, 3) symmetric f32 -> (evals (..., 3) descending, vmin (..., 3)
    unit eigenvector of the smallest eigenvalue with vmin[..., 2] >= 0,
    the reference's sign flip at patchworkpp.cpp:68)."""
    e0, e1, e2, vx, vy, vz = eig3_plane_columns(
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2],
    )
    evals = torch.stack([e0, e1, e2], dim=-1)
    vmin = torch.stack([vx, vy, vz], dim=-1)
    flip = vmin[..., 2] < 0
    vmin = torch.where(flip[..., None], -vmin, vmin)
    return evals, vmin
