"""Tensor ops of the PyTorch port, plus two helpers shared across them."""

from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float.

    Every literal that meets a float32 tensor goes through this, so that the
    tensor op sees the same constant as the JAX package's ``jnp.float32(v)``
    and as the CUDA source's ``vf`` literal, whatever precision the op is
    evaluated in (one op on two float32 values rounds the same either way)."""
    return float(np.float32(v))


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c``, as XLA computes it: ``a`` times the
    float32 reciprocal of ``float32(c)``, rounded once on the host.

    XLA's algebraic simplifier rewrites a division by a constant into that
    multiply, so the JAX package's ``x / 10.0`` is ``x * float32(0.1)``.
    One float32 multiply by a float32 scalar rounds the same way on the CPU
    and on the card (PyTorch's own CUDA division by a Python scalar also
    multiplies by a reciprocal, but one it rounds itself)."""
    r = np.float32(1.0) / np.float32(c)
    return a * float(r)


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every subnormal value replaced by a zero of its sign.

    XLA:CPU runs with flush-to-zero, so a subnormal result of the JAX
    package's ``atan2`` reads as 0 in the next step (a point at (3, 3e-39)
    gets theta 0 and wraps to 2*pi, sector 15); glibc's ``atan2f``, and so
    ``ops/trig.py:atan2_f32``, return the subnormal itself. Flushing the
    result, not the operands, gives the JAX package's bins: with flushed
    operands a point at x = -1e-45 on the +y axis gets pi/2, where XLA
    keeps 1.5707962513. Three elementwise ops: ``t * 0`` keeps the sign,
    and NaN and infinities pass."""
    return t * (t.abs() >= 2.0**-126)


def sq_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x*x + y*y`` in float32 as XLA:CPU computes it: contracted into
    ``fma(x, x, y*y)``, one rounding of the exact ``x*x`` plus ``y*y``.

    ``y*y`` is rounded to float32; ``x*x`` is exact in float64 (24-bit
    factors); their float64 sum is made round-to-odd with a TwoSum error
    term, and round-to-odd at 53 bits then rounds to the correctly rounded
    float32 (Boldo and Melquiond, "Emulation of FMA and correctly rounded
    sums", IEEE TC 2008). Separate tensor ops, so the same bits on every
    device. The inputs are finite and of either sign; the sum is >= 0."""
    xd = x.double()
    a = xd * xd
    b = (y * y).double()
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    bits = s.view(torch.int64)
    odd = (bits & 1) == 1
    bits = torch.where((e != 0) & ~odd, bits + torch.sign(e).to(torch.int64), bits)
    return bits.view(torch.float64).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's CPU ``sqrt`` on large float32 (and float64) tensors is not
    correctly rounded (about 0.6% of random inputs are off by an ulp on an
    AVX-512 host), while CUDA's and the fit kernel's ``sqrtf`` are. The
    float64 root rounded to float32 is within one ulp of the right value;
    one exact test against the neighbouring midpoints, squared in float64
    (25-bit values, exact products), moves it to the correctly rounded one.
    """
    xd = x.double()
    s = torch.sqrt(xd).float()
    inf = torch.full_like(s, float("inf"))
    up, dn = torch.nextafter(s, inf), torch.nextafter(s, -inf)
    sd = s.double()
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    fix = (xd > 0) & (xd < float("inf"))  # positive and finite
    s = torch.where(fix & (xd > hi * hi), up, s)
    return torch.where(fix & (xd < lo * lo), dn, s)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order.

    The axis is zero-padded to a power of two and halved in place
    (``v[..., :h] + v[..., h:]``) until one column is left. For a 128-wide
    tile this is exactly the order of the fit kernels' warp reductions
    (csrc/fit_math.cuh ``tile_sum``, and ``Fold`` in csrc/fit_grid.cu), so
    the plain versions and the kernels give the same bits on every device; ``torch.sum`` leaves its order to
    the backend."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]
