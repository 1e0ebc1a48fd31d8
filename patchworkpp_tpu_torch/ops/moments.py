"""Masked per-patch second-order moments, the reduction behind every plane
fit of the unfused engine (port of ``ops/moments.py``).

The 10 monomials [1, x, y, z, xx, xy, xz, yy, yz, zz] are taken on
coordinates shifted by a static per-patch offset, so the f32 E[xx] - E[x]^2
cancellation stays far from the covariance's magnitude.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import fma


def masked_moment_features_cols(qx, qy, qz, mask_f) -> torch.Tensor:
    """(P,) shifted coordinate columns + 0/1 f32 mask -> (P, 10) masked
    monomials, with the mask folded into the coordinates: for m in {0, 1},
    (m*x)*(m*y) equals (x*y)*m (the coordinates are finite after the
    frame's sanitizing)."""
    mx = qx * mask_f
    my = qy * mask_f
    mz = qz * mask_f
    return torch.stack(
        [mask_f, mx, my, mz, mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz],
        dim=1,
    )


def moments_to_mean_cov(moments: torch.Tensor, shift: torch.Tensor):
    """(S, 10) moment sums + (S, 3) shifts -> n (S,), mean (S, 3) in
    unshifted coordinates, cov (S, 3, 3) with the C++ n - 1 denominator
    (n == 1 gives a non-finite covariance, as in the reference)."""
    n = moments[:, 0]
    safe_n = torch.clamp_min(n, 1.0)
    mean_q = moments[:, 1:4] / safe_n[:, None]
    sxx, sxy, sxz = moments[:, 4], moments[:, 5], moments[:, 6]
    syy, syz, szz = moments[:, 7], moments[:, 8], moments[:, 9]
    mx, my, mz = mean_q[:, 0], mean_q[:, 1], mean_q[:, 2]
    denom = n - 1.0
    # s - (n*m)*m with the outer product fused, as XLA:CPU compiles it
    cxx = fma(-(n * mx), mx, sxx) / denom
    cxy = fma(-(n * mx), my, sxy) / denom
    cxz = fma(-(n * mx), mz, sxz) / denom
    cyy = fma(-(n * my), my, syy) / denom
    cyz = fma(-(n * my), mz, syz) / denom
    czz = fma(-(n * mz), mz, szz) / denom
    cov = torch.stack(
        [
            torch.stack([cxx, cxy, cxz], dim=-1),
            torch.stack([cxy, cyy, cyz], dim=-1),
            torch.stack([cxz, cyz, czz], dim=-1),
        ],
        dim=-2,
    )
    return n, mean_q + shift, cov
