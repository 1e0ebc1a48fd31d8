"""Fit math shared by both fit kernels and their plain versions, and the
unrolled fit kernel K2 (port of ``patchworkpp_tpu/ops/pallas/fit_kernel.py``).

Holds the per-patch result table layout, the canonical pass program, the
moments -> plane-row arithmetic (reference estimate_plane,
cpp/patchworkpp/src/patchworkpp.cpp:47-75; csrc/fit_math.cuh ``plane_row``
repeats ``plane_row_from_moments`` operation for operation), and
``fused_fit``: the TPU kernel ``fused_fit`` (``fused="onehot"``) as the CUDA
kernel csrc/fit_onehot.cu (the fit program of csrc/fit_program.cuh with
plain f32 per-patch sums), with its plain version ``fused_fit_reference``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from patchworkpp_tpu_torch.ops import f32, fma, nvcc
from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns
from patchworkpp_tpu_torch.params import CZMGeometry, Params

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
OUT_SVALS = 35      # 35:38 eigenvalues of the final covariance, descending
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
    # m - (n*mq)*mq with the outer product fused into the subtraction, and
    # the plane offset's dot product fused, as XLA:CPU compiles them
    cxx = fma(-(n * mqx), mqx, m[4]) / denom
    cxy = fma(-(n * mqx), mqy, m[5]) / denom
    cxz = fma(-(n * mqx), mqz, m[6]) / denom
    cyy = fma(-(n * mqy), mqy, m[7]) / denom
    cyz = fma(-(n * mqy), mqz, m[8]) / denom
    czz = fma(-(n * mqz), mqz, m[9]) / denom
    _, _, _, vx, vy, vz = eig3_plane_columns(cxx, cxy, cxz, cyy, cyz, czz)
    flip = vz < 0
    nx = torch.where(flip, -vx, vx)
    ny = torch.where(flip, -vy, vy)
    nz = torch.where(flip, -vz, vz)
    mx = mqx + spx
    my = mqy + spy
    mz = mqz + spz
    d = -fma(nz, mz, fma(nx, mx, ny * my))
    nx, ny, nz, d = apply_plane_sentinel(nx, ny, nz, d)
    return torch.stack(
        [nx, ny, nz, d, n, cxx, cxy, cxz, cyy, cyz, czz, mx, my, mz], dim=1
    )


# ---- K2: the unrolled fit kernel (fused="onehot") --------------------------

SOURCE = nvcc.CSRC / "fit_onehot.cu"
ONEHOT_SPAD = 512   # the TPU kernel's fixed patch space
ONEHOT_SNAPS = 3    # and its fixed number of R-VPF snapshot slots


def check_onehot_limits(params: Params, spad: int, mode="onehot") -> None:
    """The TPU kernels' fixed layout: a 512-patch space and 3 snapshot
    slots. Raises the JAX package's ValueError (pipeline.py:422-438)."""
    if spad != ONEHOT_SPAD:
        npz = CZMGeometry.create(params).num_patches
        raise ValueError(
            f"fused={mode!r} is a Pallas kernel compiled for the native "
            f"{ONEHOT_SPAD}-patch space, but this CZM needs spad={spad} "
            f"({npz} patches); use fused='tiled' (default) or fused=False"
        )
    if params.enable_RVPF and params.num_iter > ONEHOT_SNAPS:
        raise ValueError(
            f"fused={mode!r} is a Pallas kernel with a fixed 3-snapshot "
            f"R-VPF output layout, but num_iter={params.num_iter} needs "
            f"{params.num_iter} snapshots; use fused='tiled' (default) or "
            "fused=False"
        )


def fused_fit_reference(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts, params: Params,
):
    """Plain PyTorch version of K2: the (512, 48) fit table.

    The TPU kernel runs the pass program of :func:`build_pass_program`
    (count -> lprsum -> fitseed per seed round, then the fitdist refits);
    each round's three passes compute the same values as the tiled
    program's fused SEEDFIT pass. What differs from K1 is the per-patch
    sum: the TPU kernel's HIGHEST-precision one-hot dots are plain f32
    sums, here of the tile sums (``ops.row_sum`` order) added in tile
    order, as the CUDA kernel adds them. Arguments as
    :func:`~patchworkpp_tpu_torch.ops.fit_kernel_grid.fused_fit_grid`."""
    from patchworkpp_tpu_torch.ops.tiled_fit import _reduce_tiles_f32, tiled_fit

    check_onehot_limits(params, gates.shape[0])
    return tiled_fit(
        xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts[0], params,
        reduce=_reduce_tiles_f32,
    )


_ptr, _i32, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The fit program's C entry points (ppk_fit_grid, ppk_fit_onehot): their
# parameters, in order
ARGTYPES = (
    _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # xs ys zs valid pad gates consts prog
    _i32,                                            # npasses
    _ptr, _ptr,                                      # mask (scratch), out
    _i32, _i32, _i32, _i32, _i32, _i32,              # nt spad out_cols snap carry2 num_lpr
    _flt, _flt,                                      # th_dist_v uprightness_thr
    _ptr,                                            # stream
)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/fit_onehot.cu (once per source content) and load it."""
    return nvcc.build(SOURCE, "ppk_fit_onehot", ARGTYPES)


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


def fused_fit(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts, params: Params,
):
    """Per-patch fit table of the tiled cloud, with K2's per-patch sums.

    Args as :func:`~patchworkpp_tpu_torch.ops.fit_kernel_grid.fused_fit_grid`,
    over the fixed 512-patch space (``check_onehot_limits``).

    Returns:
      (512, 48) f32 table (``OUT_*`` layout). On a CPU tensor this is
      :func:`fused_fit_reference`; on a CUDA tensor the kernel, or an error.
    """
    from patchworkpp_tpu_torch.ops.fit_kernel_grid import launch_fit_program

    if xs.device.type == "cpu":
        return fused_fit_reference(
            xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts, params
        )
    if xs.device.type != "cuda":
        raise ValueError(f"fit kernel runs on CUDA or CPU tensors, not {xs.device}")
    check_onehot_limits(params, gates.shape[0])
    out = launch_fit_program(
        build().ppk_fit_onehot, "K2",
        xs, ys, zs, valid_f, pad_start, gates, consts, params,
    )
    fused_fit.launches += 1
    return out


# Launches of the CUDA kernel (plain-version calls do not count).
fused_fit.launches = 0
