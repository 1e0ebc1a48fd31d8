"""Per-patch layout of the sorted points (port of ``ops/segments.py``).

One global sort by (patch_id, z) puts each patch in a contiguous
ascending-z run; LPR ranks become a cumulative sum. The z sort keys are held
as int64 values in [0, 2**32): torch has no general uint32 arithmetic, and
the sort packs ``(patch_id << 32) | key`` into one int64 key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SIGN = 0x80000000
_LOW31 = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


def z_sort_key(z: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2**32), order-preserving for NaN-free input
    (sign-flip trick; +inf maps above every finite value)."""
    b = z.contiguous().view(torch.int32).to(torch.int64) & _U32
    flip = torch.where(b >= _SIGN, _SIGN | _LOW31, _SIGN)
    return b ^ flip


def z_sort_key_inverse(k: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`z_sort_key`: the exact f32 bits back."""
    flip = torch.where(k < _SIGN, _SIGN | _LOW31, _SIGN)
    b = k ^ flip
    b = torch.where(b >= _SIGN, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


class SortedPoints(NamedTuple):
    """Points sorted by (patch_id, z), as (P,) columns."""

    x: torch.Tensor          # (P,) float32
    y: torch.Tensor          # (P,)
    z: torch.Tensor          # (P,)
    patch_id: torch.Tensor   # (P,) int32, nondecreasing
    start: torch.Tensor      # (S+1,) int32: start row of each patch's run


def sort_by_patch(x, y, z, patch_id, width: int = 512) -> SortedPoints:
    """Sort points by (patch_id, z); the overflow bucket lands at the end.

    One stable sort on the int64 key ``(patch_id << 32) | z_key``, as
    ``ops/tiled.py:build_tiled`` does: rows with bit-identical (patch, z)
    keys keep their input order on every device (the JAX package's sort is
    unstable; such ties only permute rows inside a patch's run)."""
    from patchworkpp_tpu_torch.ops.binning import patch_counts as id_counts

    key = (patch_id.to(torch.int64) << 32) | z_sort_key(z)
    key_s, order = torch.sort(key, stable=True)
    counts = id_counts(patch_id, width).to(torch.int32)
    start = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=x.device),
        torch.cumsum(counts, 0).to(torch.int32),
    ])
    return SortedPoints(
        x=x[order], y=y[order], z=z_sort_key_inverse(key_s & _U32),
        patch_id=(key_s >> 32).to(torch.int32), start=start,
    )


def patch_counts(sp: SortedPoints) -> torch.Tensor:
    """(S,) float32 point count of each patch bucket."""
    return (sp.start[1:] - sp.start[:-1]).to(torch.float32)


def segment_rank(mask: torch.Tensor, sp: SortedPoints) -> torch.Tensor:
    """Exclusive rank of each point among the mask-true points of its
    patch, in sorted (ascending z) order: an int64 cumulative sum, exact."""
    m = mask.to(torch.int64)
    incl = torch.cumsum(m, 0)
    excl = incl - m
    # the exclusive count at each patch's first row (the total past the end)
    base = torch.cat([excl, incl[-1:]])[sp.start[:-1].to(torch.int64)]
    return excl - base[sp.patch_id.to(torch.int64)]
