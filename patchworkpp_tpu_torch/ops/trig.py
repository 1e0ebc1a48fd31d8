"""Polynomial trig for the Cardano 3x3 eigensolver (port of ops/trig.py),
and the binning's float32 ``atan2``.

Built from add/mul/sqrt only, term by term after the JAX package, so that
the eigensolver gives the same bits here, in the JAX package on the CPU and
in the CUDA fit kernels (csrc/fit_math.cuh repeats these polynomials).
XLA:CPU fuses each Horner step's multiply into its add, and the last
step's products of ``cos(phi + 2pi/3)`` into one subtraction, so these
steps are ``ops.fma``:

- ``acos(r)`` on [-1, 1]: Hastings' approximation (Abramowitz & Stegun
  4.4.45, 8 terms), |err| < 2e-8;
- ``sin``/``cos`` on [0, pi/3], the range ``acos(r)/3`` spans: Taylor series.

``atan2_f32`` is the fdlibm float routine (``e_atan2f.c`` / ``s_atanf.c``)
that glibc's ``atan2f`` is, and that XLA:CPU calls for ``jnp.arctan2``.
Every step is a separate float32 tensor op (tensor-by-tensor divisions, no
op that could fuse a multiply into an add), so it gives the same bits on
the CPU and on the card, and the same bits as the JAX package on the CPU.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import f32, fma, sqrt

_PI = 3.14159265358979323846

_ACOS_COEF = (
    1.5707963050,
    -0.2145988016,
    0.0889789874,
    -0.0501743046,
    0.0308918810,
    -0.0170881256,
    0.0066700901,
    -0.0012624911,
)


def acos_poly(x: torch.Tensor) -> torch.Tensor:
    """acos on [-1, 1] via Hastings' polynomial (reflected for x < 0)."""
    ax = torch.abs(x)
    poly = torch.full_like(x, f32(_ACOS_COEF[-1]))
    for c in _ACOS_COEF[-2::-1]:
        poly = fma(poly, ax, f32(c))
    pos = sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    return torch.where(x >= 0, pos, f32(_PI) - pos)


def sin_narrow(phi: torch.Tensor) -> torch.Tensor:
    """sin(phi) for phi in [0, pi/3], Taylor to phi^11."""
    p2 = phi * phi
    s = torch.full_like(phi, f32(-1.0 / 39916800.0))
    for c in (1.0 / 362880.0, -1.0 / 5040.0, 1.0 / 120.0, -1.0 / 6.0, 1.0):
        s = fma(s, p2, f32(c))
    return s * phi


def cos_narrow(phi: torch.Tensor) -> torch.Tensor:
    """cos(phi) for phi in [0, pi/3], Taylor to phi^12."""
    p2 = phi * phi
    s = torch.full_like(phi, f32(1.0 / 479001600.0))
    for c in (-1.0 / 3628800.0, 1.0 / 40320.0, -1.0 / 720.0, 1.0 / 24.0,
              -1.0 / 2.0, 1.0):
        s = fma(s, p2, f32(c))
    return s


def cardano_cos_pair(r: torch.Tensor):
    """(cos(phi), cos(phi + 2pi/3)) for phi = acos(r)/3, r in [-1, 1]."""
    phi = acos_poly(r) * f32(1.0 / 3.0)
    c, s = cos_narrow(phi), sin_narrow(phi)
    c_hi = fma(f32(-0.5), c, -(f32(0.8660254037844386) * s))
    return c, c_hi


# s_atanf.c: atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo parts, and
# the 11 coefficients of the odd polynomial (the C source's literals)
_ATANHI = tuple(map(f32, (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
                          1.5707962513e+00)))
_ATANLO = tuple(map(f32, (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
                          7.5497894159e-08)))
_AT = tuple(map(f32, (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
    9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
    4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02,
)))
# e_atan2f.c
_PI_F = f32(3.1415927410e+00)
_PI_O_2 = f32(1.5707963705e+00)
_PI_O_4 = f32(7.8539818525e-01)
_PI_LO = f32(-8.7422776573e-08)


def _atanf_pos(a: torch.Tensor) -> torch.Tensor:
    """fdlibm ``__atanf`` for finite a >= 0 (float32 tensor)."""
    one = torch.ones_like(a)
    ia = a.view(torch.int32)
    # argument reduction: id -1 (|a| < 7/16), 0 .. 3 (atan(0.5), atan(1),
    # atan(1.5), atan(inf) subtracted)
    red = [
        a,
        (2.0 * a - one) / (2.0 + a),
        (a - one) / (a + one),
        (a - 1.5) / (one + 1.5 * a),
        -one / a,
    ]
    ida = torch.full_like(ia, 3)
    ida = torch.where(ia < 0x401C0000, 2, ida)
    ida = torch.where(ia < 0x3F980000, 1, ida)
    ida = torch.where(ia < 0x3F300000, 0, ida)
    ida = torch.where(ia < 0x3EE00000, -1, ida)
    x = red[4]
    for i in (2, 1, 0, -1):
        x = torch.where(ida == i, red[i + 1], x)

    z = x * x
    w = z * z
    s1 = torch.full_like(w, _AT[10])
    for c in (_AT[8], _AT[6], _AT[4], _AT[2], _AT[0]):
        s1 = c + w * s1
    s1 = z * s1
    s2 = torch.full_like(w, _AT[9])
    for c in (_AT[7], _AT[5], _AT[3], _AT[1]):
        s2 = c + w * s2
    s2 = w * s2
    xs = x * (s1 + s2)

    hi = torch.full_like(x, _ATANHI[3])
    lo = torch.full_like(x, _ATANLO[3])
    for i in (2, 1, 0):
        hi = torch.where(ida == i, _ATANHI[i], hi)
        lo = torch.where(ida == i, _ATANLO[i], lo)
    out = torch.where(ida < 0, x - xs, hi - ((xs - lo) - x))
    # |a| < 2^-29 returns a itself; |a| >= 2^25 returns atanhi[3] + atanlo[3]
    out = torch.where(ia < 0x31000000, a, out)
    return torch.where(ia >= 0x4C000000, f32(_ATANHI[3] + _ATANLO[3]), out)


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atan2f(y, x)``, elementwise (fdlibm e_atan2f.c).

    Quadrant handling as in e_atan2f.c: zeros and infinities first, then
    z = atan(|y / x|) with a shortcut when the exponents differ by more than
    60, mapped to the quadrant with pi's hi/lo parts."""
    hx = x.view(torch.int32)
    hy = y.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    iy = hy & 0x7FFFFFFF
    neg_x = hx < 0
    neg_y = hy < 0
    inf = 0x7F800000

    ratio = torch.abs(y / torch.where(ix == 0, 1.0, x))
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.0)
    z = _atanf_pos(ratio)
    k = (iy - ix) >> 23
    z = torch.where(k > 60, f32(_PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where(neg_x & (k < -60), 0.0, z)
    # x = 1.0 exactly: atanf(y) keeps y's sign (and -0.0)
    out = torch.where(
        neg_x,
        torch.where(neg_y, (z - _PI_LO) - _PI_F, _PI_F - (z - _PI_LO)),
        torch.where(neg_y, -z, z),
    )

    # x = +-inf (y finite): +-0 or +-pi; both infinite: +-pi/4 or +-3pi/4
    sgn_y = torch.where(neg_y, -1.0, 1.0)
    x_inf = torch.where(neg_x, f32(_PI_F) * sgn_y, 0.0 * sgn_y)
    both_inf = torch.where(neg_x, f32(3.0 * _PI_O_4), f32(_PI_O_4)) * sgn_y
    x_inf = torch.where(iy == inf, both_inf, x_inf)
    out = torch.where(ix == inf, x_inf, out)
    # y = +-inf (x finite) or x = +-0 (y nonzero): +-pi/2
    out = torch.where(
        ((iy == inf) & (ix != inf)) | ((ix == 0) & (iy != 0)),
        f32(_PI_O_2) * sgn_y, out,
    )
    # y = +-0: +-0 for x >= +0, +-pi for x <= -0
    out = torch.where(iy == 0, torch.where(neg_x, f32(_PI_F) * sgn_y, y), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)
