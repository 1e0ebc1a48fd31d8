"""Fit math shared by the fit program's plain version and its CUDA kernel
(port of the math half of ``patchworkpp_tpu/ops/pallas/fit_kernel.py``).

Holds the per-patch result table layout, the canonical pass program and the
moments -> plane-row arithmetic (reference estimate_plane,
cpp/patchworkpp/src/patchworkpp.cpp:47-75). csrc/fit_grid.cu ``plane_row``
repeats ``plane_row_from_moments`` operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patchworkpp_tpu_torch.ops import f32
from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns
from patchworkpp_tpu_torch.params import Params

# Per-patch result table columns (the canonical 48-column layout; see
# tiled_fit.out_layout for num_iter > 3).
OUT_NORMAL = 0      # 0:3
OUT_D = 3
OUT_MEAN = 4        # 4:7
OUT_N = 7
OUT_GCOUNT = 8
OUT_COV = 9         # 9:15 (cxx, cxy, cxz, cyy, cyz, czz)
OUT_SNAP = 16       # 5 per R-VPF snapshot: [gate, nx, ny, nz, d]
OUT_CARRY2 = 31     # [nx, ny, nz, d] of the plane that defines the final g
OUT_COLS = 48

# Plane-state row: [nx, ny, nz, d, n, cxx, cxy, cxz, cyy, cyz, czz, mx, my, mz]
PLANE_COLS = 14


class PassSpec(NamedTuple):
    kind: str            # 'count' | 'lprsum' | 'fitseed' | 'fitdist'
    peel_snap: int       # snapshot slot to peel with before counting (-1: none)
    th: float            # seed threshold / distance threshold
    gate_alive: bool     # fit gate: alive (R-VPF) vs processed (R-GPF)
    snap_slot: int       # R-VPF snapshot slot to record (-1: none)
    is_final: bool       # last R-GPF iteration (save carry2 + g_count)


def build_pass_program(p: Params):
    """The canonical unrolled pass program (R-VPF rounds, then R-GPF)."""
    passes = []
    if p.enable_RVPF:
        for i in range(p.num_iter):
            passes.append(PassSpec("count", i - 1, 0.0, True, -1, False))
            passes.append(PassSpec("lprsum", -1, 0.0, True, -1, False))
            passes.append(PassSpec("fitseed", -1, p.th_seeds_v, True, i, False))
        last_snap = p.num_iter - 1
    else:
        last_snap = -1
    passes.append(PassSpec("count", last_snap, 0.0, False, -1, False))
    passes.append(PassSpec("lprsum", -1, 0.0, False, -1, False))
    passes.append(PassSpec("fitseed", -1, p.th_seeds, False, -1, False))
    for i in range(p.num_iter):
        passes.append(
            PassSpec("fitdist", -1, p.th_dist, False, -1, i == p.num_iter - 1)
        )
    return passes


def _lane_prefix_exclusive(m: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count along the last axis of a 0/1 int tensor."""
    return torch.cumsum(m, dim=-1, dtype=torch.int32) - m


def apply_plane_sentinel(nx, ny, nz, d):
    """Non-finite plane (a 1-point fit: cov is 0/0) -> [0, 0, 0, 1e30], which
    fails every consumer's test the way the reference's NaN plane does."""
    fin = (
        torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
        & torch.isfinite(d)
    )
    zero = torch.zeros_like(nx)
    return (
        torch.where(fin, nx, zero),
        torch.where(fin, ny, zero),
        torch.where(fin, nz, zero),
        torch.where(fin, d, torch.full_like(d, f32(1e30))),
    )


def plane_row_from_moments(momp, spx, spy, spz):
    """(S, 10) raw moment sums [n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz]
    of shifted coordinates + (S,) per-patch shifts -> (S, 14) plane rows."""
    m = momp.unbind(1)
    n = m[0]
    safe_n = torch.clamp_min(n, 1.0)
    mqx = m[1] / safe_n
    mqy = m[2] / safe_n
    mqz = m[3] / safe_n
    denom = n - 1.0
    cxx = (m[4] - n * mqx * mqx) / denom
    cxy = (m[5] - n * mqx * mqy) / denom
    cxz = (m[6] - n * mqx * mqz) / denom
    cyy = (m[7] - n * mqy * mqy) / denom
    cyz = (m[8] - n * mqy * mqz) / denom
    czz = (m[9] - n * mqz * mqz) / denom
    _, _, _, vx, vy, vz = eig3_plane_columns(cxx, cxy, cxz, cyy, cyz, czz)
    flip = vz < 0
    nx = torch.where(flip, -vx, vx)
    ny = torch.where(flip, -vy, vy)
    nz = torch.where(flip, -vz, vz)
    mx = mqx + spx
    my = mqy + spy
    mz = mqz + spz
    d = -(nx * mx + ny * my + nz * mz)
    nx, ny, nz, d = apply_plane_sentinel(nx, ny, nz, d)
    return torch.stack(
        [nx, ny, nz, d, n, cxx, cxy, cxz, cyy, cyz, czz, mx, my, mz], dim=1
    )
