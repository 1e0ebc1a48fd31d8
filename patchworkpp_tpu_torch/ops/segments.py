"""Order-preserving z sort key (port of ops/segments.py:36-56).

The keys are held as int64 values in [0, 2**32): torch has no general
uint32 arithmetic, and the tiled layout packs ``(patch_id << 32) | key``
into one int64 sort key anyway.
"""

from __future__ import annotations

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
