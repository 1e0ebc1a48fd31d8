"""Masked per-patch second-order moments, the reduction behind every plane
fit of the unfused engine (port of ``ops/moments.py``), and the public
``moment_features`` / ``masked_patch_moments`` of the JAX package's ops.

The 10 monomials [1, x, y, z, xx, xy, xz, yy, yz, zz] are taken on
coordinates shifted by a static per-patch offset, so the f32 E[xx] - E[x]^2
cancellation stays far from the covariance's magnitude.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import fma


def moment_features(q: torch.Tensor) -> torch.Tensor:
    """(P, 3) shifted coordinates -> (P, 10) monomials
    [1, x, y, z, xx, xy, xz, yy, yz, zz] (products only, so every device
    gives the JAX package's bits)."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return torch.stack(
        [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], dim=1
    )


def masked_patch_moments(
    q: torch.Tensor,
    mask: torch.Tensor,
    patch_id: torch.Tensor,
    num_segments: int,
    indices_are_sorted: bool = True,
) -> torch.Tensor:
    """(num_segments, 10) per-patch sums of ``moment_features(q)`` over the
    points where ``mask`` (P,) is true; ``patch_id`` (P,) holds each point's
    segment, and ids outside [0, num_segments) are dropped.

    The JAX package's ``jax.ops.segment_sum`` is a scatter-add, which
    XLA:CPU runs one point after another: each segment's sum is its rows
    added in point order to a 0. Here each segment's rows are grouped by a
    stable sort (which keeps that order) and added one rank at a time over
    all segments at once, so the sums are the same on every device
    (``index_add_`` on the card adds with atomics, in no fixed order).
    ``indices_are_sorted`` is the JAX signature's hint; the order of the
    sums does not depend on it.

    Cost: a host sync for the largest segment's size, then one step of
    six small tensor ops per rank of it. A 64-beam scan binned at capacity
    131072 has a patch of ~7.8k points, so a call makes ~47k launches on
    the card (``chip_smoke.py`` phase 4f times it; PERF.md). No engine
    calls it: the unfused engine sums its moments with ``ops.patch_reduce``."""
    feats = moment_features(q) * mask[:, None].to(q.dtype)
    pid = patch_id.to(torch.int64)
    pid = torch.where((pid >= 0) & (pid < num_segments), pid, num_segments)
    pid_s, order = torch.sort(pid, stable=True)
    rows = feats[order]
    counts = torch.bincount(pid_s, minlength=num_segments + 1)[:num_segments]
    first = torch.searchsorted(pid_s, torch.arange(num_segments, device=pid.device))
    acc = torch.zeros((num_segments, 10), dtype=feats.dtype, device=feats.device)
    last = max(rows.shape[0] - 1, 0)
    for k in range(int(counts.max()) if num_segments else 0):
        row = rows[torch.clamp_max(first + k, last)]
        acc = torch.where((k < counts)[:, None], acc + row, acc)
    return acc


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
