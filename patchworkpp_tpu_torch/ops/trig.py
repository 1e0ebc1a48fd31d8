"""Polynomial trig for the Cardano 3x3 eigensolver (port of ops/trig.py).

Built from add/mul/sqrt only, term by term after the JAX package, so that
the eigensolver gives the same bits here, in the JAX package and in the
CUDA fit kernel (csrc/fit_grid.cu repeats these polynomials):

- ``acos(r)`` on [-1, 1]: Hastings' approximation (Abramowitz & Stegun
  4.4.45, 8 terms), |err| < 2e-8;
- ``sin``/``cos`` on [0, pi/3], the range ``acos(r)/3`` spans: Taylor series.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import f32, sqrt

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
        poly = poly * ax + f32(c)
    pos = sqrt(torch.clamp_min(1.0 - ax, 0.0)) * poly
    return torch.where(x >= 0, pos, f32(_PI) - pos)


def sin_narrow(phi: torch.Tensor) -> torch.Tensor:
    """sin(phi) for phi in [0, pi/3], Taylor to phi^11."""
    p2 = phi * phi
    s = torch.full_like(phi, f32(-1.0 / 39916800.0))
    for c in (1.0 / 362880.0, -1.0 / 5040.0, 1.0 / 120.0, -1.0 / 6.0, 1.0):
        s = s * p2 + f32(c)
    return s * phi


def cos_narrow(phi: torch.Tensor) -> torch.Tensor:
    """cos(phi) for phi in [0, pi/3], Taylor to phi^12."""
    p2 = phi * phi
    s = torch.full_like(phi, f32(1.0 / 479001600.0))
    for c in (-1.0 / 3628800.0, 1.0 / 40320.0, -1.0 / 720.0, 1.0 / 24.0,
              -1.0 / 2.0, 1.0):
        s = s * p2 + f32(c)
    return s


def cardano_cos_pair(r: torch.Tensor):
    """(cos(phi), cos(phi + 2pi/3)) for phi = acos(r)/3, r in [-1, 1]."""
    phi = acos_poly(r) * f32(1.0 / 3.0)
    c, s = cos_narrow(phi), sin_narrow(phi)
    c_hi = f32(-0.5) * c - f32(0.8660254037844386) * s
    return c, c_hi
