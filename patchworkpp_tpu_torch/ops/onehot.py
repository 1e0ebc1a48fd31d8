"""Patch <-> point data movement of the unfused engine (port of
``ops/onehot.py``).

The JAX package moves per-patch tables to points and sums points into
patches with one-hot matrix products, because gathers and scatter-adds are
slow on the TPU. Here a lookup is a gather, which returns the same values.
A reduction is a per-patch sum over the sorted rows in a fixed order, the
same on the CPU and on the card (``index_add_``'s CUDA atomics have none):
each patch's run is cut into 128-row chunks, each chunk is summed in
``ops.tree_sum``'s order, and a patch's chunk sums are added in order.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import tree_sum

# The padded patch space: 504 patches and the overflow bucket, padded to
# 512 (the JAX package's ``ops/onehot.py:SPAD``; ``CZMGeometry.spad``).
SPAD = 512
CHUNK = 128


def patch_lookup(table: torch.Tensor, patch_id: torch.Tensor) -> torch.Tensor:
    """(S, C) per-patch table -> (P, C): ``table[patch_id[i]]``."""
    return table[patch_id.to(torch.int64)]


def patch_lookup_cols(table: torch.Tensor, patch_id: torch.Tensor) -> torch.Tensor:
    """(S, C) per-patch table -> (C, P): ``table[patch_id[i], c]``."""
    return patch_lookup(table, patch_id).T


def patch_reduce(feats: torch.Tensor, patch_id: torch.Tensor,
                 start: torch.Tensor) -> torch.Tensor:
    """(P, C) per-row features -> (S, C) per-patch sums.

    ``patch_id`` is nondecreasing (sorted rows) and ``start`` (S+1,) holds
    each patch's first row, as in :class:`~.segments.SortedPoints`."""
    p, c = feats.shape
    s = start.shape[0] - 1
    dev = feats.device
    pid = patch_id.to(torch.int64)
    st = start.to(torch.int64)
    nch = (st[1:] - st[:-1] + (CHUNK - 1)) // CHUNK       # chunks per patch
    first = torch.cumsum(nch, 0) - nch                    # a patch's first chunk
    total = p // CHUNK + s + 1                            # bound on the chunks
    pos = torch.arange(p, device=dev) - st[pid]
    slot = (first[pid] + pos // CHUNK) * CHUNK + pos % CHUNK
    buf = torch.zeros((total * CHUNK, c), dtype=feats.dtype, device=dev)
    buf[slot] = feats                                     # every slot once
    per = tree_sum(buf.reshape(total, CHUNK, c).transpose(1, 2))  # (total, C)

    tmax = int(nch.max()) if s else 0
    acc = torch.zeros((s, c), dtype=feats.dtype, device=dev)
    zero = torch.zeros((), dtype=feats.dtype, device=dev)
    for j in range(tmax):
        idx = torch.clamp_max(first + j, total - 1)
        acc = acc + torch.where((j < nch)[:, None], per[idx], zero)
    return acc
