"""Per-point stage: RNR noise mask + CZM patch assignment (port of
``patchworkpp_tpu/ops/binning.py``; reference patchworkpp.cpp:377-400 and
:578-622).

Every point gets a flat patch id in the static patch space; out-of-range,
noise and padding rows get the overflow id ``num_patches``. The f32
expression order follows the JAX package, and each step rounds as the JAX
package's compiled program rounds it on the CPU, so a point that sits on a
ring or sector edge lands in the same bin in both packages and on the card:

- r^2 is ``fma(x, x, y*y)`` (XLA:CPU contracts ``x*x + y*y``), correctly
  rounded (``ops.sq_sum``), and r its correctly rounded root (``ops.sqrt``);
- a division by a constant is a multiply by the constant's float32
  reciprocal, as XLA rewrites it (``ops.div``);
- both angles are glibc's ``atan2f``, which XLA:CPU calls
  (``ops/trig.py:atan2_f32``, built from float32 tensor ops), with a
  subnormal result flushed to a zero of its sign, as XLA:CPU's
  flush-to-zero reads it (``ops.flush_subnormal``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from patchworkpp_tpu_torch.ops import div, f32, flush_subnormal, sq_sum, sqrt
from patchworkpp_tpu_torch.ops.trig import atan2_f32
from patchworkpp_tpu_torch.params import CZMGeometry, Params


class PointBins(NamedTuple):
    """Per-point binning result (all shapes (P,))."""

    patch_id: torch.Tensor   # int32 in [0, num_patches]; num_patches = none
    valid: torch.Tensor      # bool: non-padding
    noise: torch.Tensor      # bool: RNR-flagged
    in_range: torch.Tensor   # bool: inside (min_range, max_range]
    ring14: torch.Tensor     # int32 concentric ring; total rings = none
    sector: torch.Tensor     # int32 sector within the ring; 0 when none


def bin_points(
    points: torch.Tensor,
    npts: int,
    sensor_height: torch.Tensor,
    params: Params,
    geom: CZMGeometry,
) -> PointBins:
    """Assign each point a flat patch id; flag RNR noise and out-of-range.

    ``points`` is (P, 4) float32 (x, y, z, intensity), rows >= ``npts`` are
    padding; ``sensor_height`` is the adapted () float32 height that RNR's
    ``z < -sensor_height - 0.8`` test reads.
    """
    p = params
    x, y, z, inten = points.unbind(1)
    n = x.shape[0]
    dev = points.device

    valid = torch.arange(n, device=dev) < npts
    r = sqrt(sq_sum(x, y))

    if p.enable_RNR:
        ver_deg = flush_subnormal(atan2_f32(z, r)) * f32(180.0 / math.pi)
        noise = (
            (ver_deg < f32(p.RNR_ver_angle_thr))
            & (z < -sensor_height - f32(0.8))
            & (inten < f32(p.RNR_intensity_thr))
            & valid
        )
    else:
        noise = torch.zeros(n, dtype=torch.bool, device=dev)

    in_range = (r <= f32(p.max_range)) & (r > f32(p.min_range)) & valid

    # flush_subnormal(theta), then wrap theta <= 0 by 2*pi, in one op: a
    # subnormal theta plus 2*pi rounds to 2*pi, as the flushed zero does
    theta = atan2_f32(y, x)
    theta = torch.where(theta >= 2.0**-126, theta, theta + f32(2 * math.pi))

    lo = list(geom.min_ranges)
    hi = lo[1:] + [p.max_range]
    nrings = p.num_rings_each_zone
    nsec = p.num_sectors_each_zone
    ring_offset = np.concatenate([[0], np.cumsum(nrings)]).astype(np.int64)

    i32 = dict(dtype=torch.int32, device=dev)
    patch_id = torch.full((n,), geom.num_patches, **i32)
    ring14 = torch.full((n,), int(ring_offset[-1]), **i32)
    sector = torch.zeros(n, **i32)
    binnable = in_range & ~noise
    for k in range(p.num_zones):
        ring = torch.clamp_max(
            torch.floor(div(r - f32(lo[k]), f32(geom.ring_sizes[k]))).to(torch.int32),
            nrings[k] - 1,
        )
        sec = torch.clamp_max(
            torch.floor(div(theta, f32(geom.sector_sizes[k]))).to(torch.int32),
            nsec[k] - 1,
        )
        if k == 0:
            zsel = r < f32(hi[0])
        elif k < p.num_zones - 1:
            zsel = (r >= f32(lo[k])) & (r < f32(hi[k]))
        else:
            zsel = r >= f32(lo[k])
        pid_k = geom.zone_patch_offset[k] + ring * nsec[k] + sec
        sel = binnable & zsel
        patch_id = torch.where(sel, pid_k, patch_id)
        ring14 = torch.where(sel, int(ring_offset[k]) + ring, ring14)
        sector = torch.where(sel, sec, sector)

    return PointBins(
        patch_id=patch_id, valid=valid, noise=noise, in_range=in_range,
        ring14=ring14, sector=sector,
    )


def patch_counts(patch_id: torch.Tensor, width: int) -> torch.Tensor:
    """(width,) float32 count of each id in [0, width).

    An integer scatter-add: exact and order-free, and unlike
    ``torch.bincount`` it needs no device -> host copy of the largest id to
    size its output, so the frame keeps its one readback."""
    counts = torch.zeros(width, dtype=torch.int32, device=patch_id.device)
    ones = torch.ones_like(patch_id, dtype=torch.int32)
    return counts.index_add_(0, patch_id.to(torch.int64), ones).to(torch.float32)


def factored_patch_counts(
    bins: PointBins, geom: CZMGeometry, width: int | None = None
) -> torch.Tensor:
    """(width,) float32 points per patch id (the overflow bucket
    ``num_patches`` holds padding, out-of-range and RNR rows).

    The JAX package forms these as a (ring, sector) one-hot histogram on the
    MXU; a count over the same ids gives the same integers for any CZM, so
    the factored grid's size limit does not apply here."""
    return patch_counts(bins.patch_id, geom.spad if width is None else width)
