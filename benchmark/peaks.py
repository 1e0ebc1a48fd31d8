"""The yardstick's arithmetic: the chip's published peaks, and the least
time of a kernel's work, counted from the benchmark's own binning of the
scans (so the count reads the same work whatever implements it).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 3.35 TB/s
of HBM3, 67 TFLOP/s of float32 outside the tensor cores. The fit kernel
K1's count is the port's own (``chip_smoke.py`` phase 5 and PERF.md §6),
copied. Bytes: the rows of the processed patches' 128-row tiles (x, y, z
and a valid flag, float32 each), the padded patch starts, the per-patch
gates (8 floats), the 8 constants, and the (spad, 48) table it writes.
Operations: ~40 float32 a row in each of its fused passes (R-VPF's
``num_iter`` seed fits, R-GPF's seed fit and its ``num_iter`` refits).
"""

from __future__ import annotations

import numpy as np

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

TILE = 128
K1_OUT_COLS = 48  # the result table's columns for num_iter <= 3
K1_OPS_PER_ROW_PASS = 40


def spad(num_patches: int) -> int:
    """The padded patch space: the patches plus an overflow bucket, rounded
    up to a multiple of 128, at least 512."""
    return max(512, -(-(num_patches + 1) // 128) * 128)


def k1_least_seconds(patch_counts: np.ndarray, params) -> float:
    """The least time K1 needs for a frame whose patches hold
    ``patch_counts`` points (after RNR and the range cut): the larger of
    its bytes at the chip's bandwidth and its operations at its float32
    rate."""
    if params.num_iter > 3:
        raise ValueError("K1's table is wider for num_iter > 3; not counted here")
    counts = np.asarray(patch_counts, np.int64)
    processed = counts >= params.num_min_pts
    rows = TILE * int((-(-counts[processed] // TILE)).sum())
    s = spad(len(counts))
    nbytes = rows * 16 + 4 * (s + 1) + 32 * s + 32 + 4 * s * K1_OUT_COLS
    passes = (params.num_iter if params.enable_RVPF else 0) + 1 + params.num_iter
    ops = rows * passes * K1_OPS_PER_ROW_PASS
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS)
