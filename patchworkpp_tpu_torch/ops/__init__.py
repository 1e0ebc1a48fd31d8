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
    """``a / c`` as an IEEE division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can round differently from the true division that
    its CPU kernels, XLA and the CUDA fit kernel perform; a divisor on the
    tensor's own device keeps it a true division."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's CPU ``sqrt`` on large float32 (and float64) tensors is not
    correctly rounded (about 0.6% of random inputs are off by an ulp on an
    AVX-512 host), while CUDA's and the fit kernel's ``sqrtf`` are. The
    float64 root rounded to float32 is within one ulp of the right value;
    one exact test against the neighbouring midpoints, squared in float64
    (25-bit values, exact products), moves it to the correctly rounded one.
    """
    s = torch.sqrt(x.double()).float()
    xd = x.double()
    inf = torch.full_like(s, float("inf"))
    up, dn = torch.nextafter(s, inf), torch.nextafter(s, -inf)
    sd = s.double()
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    fix = (xd > 0) & torch.isfinite(xd)
    s = torch.where(fix & (xd > hi * hi), up, s)
    return torch.where(fix & (xd < lo * lo), dn, s)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order.

    The axis is zero-padded to a power of two and halved in place
    (``v[..., :h] + v[..., h:]``) until one column is left. For a 128-wide
    tile this is exactly the order of the fit kernel's warp reduction
    (csrc/fit_grid.cu ``tile_sum``), so the plain version and the kernel
    give the same bits on every device; ``torch.sum`` leaves its order to
    the backend."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]
