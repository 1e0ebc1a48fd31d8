"""Tiled patch layout: every 128-row tile holds points of one patch (port of
``patchworkpp_tpu/ops/tiled.py``).

Per-patch filler rows (z = +inf, so they sort to each patch's tail) round
every patch's run up to a multiple of TILE; one sort over (patch, z) then
puts each run on tile boundaries. The fillers come from a static
(width, TILE-1) grid, so the layout length depends on the capacity alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patchworkpp_tpu_torch.ops.binning import patch_counts
from patchworkpp_tpu_torch.ops.segments import z_sort_key, z_sort_key_inverse

TILE = 128


def tiled_capacity(p: int, width: int = 512) -> int:
    """Static layout length for a P-row cloud (a multiple of TILE), sized so
    the (width, TILE-1) filler grid always fits."""
    worst = p + width * (TILE - 1)
    return -(-worst // TILE) * TILE


class TiledPoints(NamedTuple):
    xyz: torch.Tensor         # (PT, 3) f32; filler rows zeroed
    valid: torch.Tensor       # (PT,) bool: real point
    patch_id: torch.Tensor    # (PT,) int32, nondecreasing
    tile_patch: torch.Tensor  # (PT/TILE,) int32: patch owning each tile
    counts: torch.Tensor      # (width,) f32 real points per patch
    pad_start: torch.Tensor   # (width+1,) int32 tile-aligned run starts


def build_tiled(
    xyz: torch.Tensor,
    patch_id: torch.Tensor,
    counts: torch.Tensor | None = None,
    width: int = 512,
) -> TiledPoints:
    """Sort (P, 3) points with (P,) patch ids in [0, width) into the tiled
    layout. ``counts`` (width,) may be passed if already known.

    One stable sort on the int64 key ``(patch_id << 32) | z_key``: stable,
    so rows with bit-identical (patch, z) keep their input order on every
    device (the JAX package's sort is unstable; such ties only permute
    rows inside a run)."""
    dev = xyz.device
    p = xyz.shape[0]
    pt = tiled_capacity(p, width)
    nfill = pt - p
    i32 = dict(dtype=torch.int32, device=dev)

    if counts is None:
        counts = patch_counts(patch_id, width)
    counts_i = counts.to(torch.int32)
    padded = torch.div(counts_i + (TILE - 1), TILE, rounding_mode="floor") * TILE
    pad_start = torch.cat(
        [torch.zeros(1, **i32), torch.cumsum(padded, 0).to(torch.int32)]
    )

    fill_needed = padded - counts_i
    grid_i = torch.arange(TILE - 1, **i32)[None, :]
    grid_p = torch.arange(width, **i32)[:, None]
    grid_patch = torch.where(
        grid_i < fill_needed[:, None], grid_p, torch.full_like(grid_p, width)
    ).reshape(-1)
    fill_patch = torch.cat(
        [grid_patch, torch.full((nfill - width * (TILE - 1),), width, **i32)]
    )

    key_pid = torch.cat([patch_id.to(torch.int32), fill_patch]).to(torch.int64)
    key_z = torch.cat(
        [xyz[:, 2], torch.full((nfill,), float("inf"), device=dev)]
    )
    key = (key_pid << 32) | z_sort_key(key_z)
    key_s, order = torch.sort(key, stable=True)

    pid_s = (key_s >> 32).to(torch.int32)
    z_s = z_sort_key_inverse(key_s & 0xFFFFFFFF)
    valid = ~torch.isinf(z_s)
    z_s = torch.where(valid, z_s, torch.zeros_like(z_s))
    zeros = torch.zeros(nfill, dtype=xyz.dtype, device=dev)
    x_s = torch.cat([xyz[:, 0], zeros])[order]
    y_s = torch.cat([xyz[:, 1], zeros])[order]

    return TiledPoints(
        xyz=torch.stack([x_s, y_s, z_s], dim=1),
        valid=valid,
        patch_id=pid_s,
        tile_patch=pid_s[::TILE].contiguous(),
        counts=counts_i.to(torch.float32),
        pad_start=pad_start,
    )
