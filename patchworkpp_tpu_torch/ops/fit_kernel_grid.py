"""The fit kernel K1: the per-patch R-VPF/R-GPF pass program as one CUDA launch.

Replaces the TPU's Pallas grid kernel
``patchworkpp_tpu/ops/pallas/fit_kernel_grid.py:fused_fit_grid`` (whose
program the JAX engine runs as XLA ops in ``ops/tiled_fit.py``). The source
is ``csrc/fit_grid.cu``, the fit program of ``csrc/fit_program.cuh`` with
K1's per-patch sums, built by ``ops/nvcc.py`` at the first call on a CUDA
tensor. On a CPU tensor the wrapper runs the plain version
(``ops/tiled_fit.py:tiled_fit``); on a CUDA tensor it launches the kernel or
raises. :func:`launch_fit_program` launches either fit kernel (K2,
``ops/fit_kernel.py:fused_fit``, shares the program and its arguments).

The kernel runs one CTA of 16 warps per patch and keeps a patch of at most
``CAP_TILES`` tiles in shared memory; a longer patch is staged there a
chunk at a time, and keeps its per-row active bits in a small global
scratch that the wrapper allocates. Which patch is which is decided on the
card, so the call reads nothing back to the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from patchworkpp_tpu_torch.ops import f32, nvcc
from patchworkpp_tpu_torch.ops.fit_kernel import ARGTYPES, build_pass_program
from patchworkpp_tpu_torch.params import Params

K_SEEDFIT, K_FITDIST = 0, 1
LANE = 128
SOURCE = nvcc.CSRC / "fit_grid.cu"
# kCapTiles of the source: the longest patch (in 128-row tiles) whose rows
# the kernel keeps in shared memory
CAP_TILES = 64


def _pass_config(p: Params):
    """Fuse each (count, lprsum, fitseed) triple of the canonical pass
    program into one SEEDFIT pass. Returns (npasses, kind, peel, snap,
    gate_alive, final, th) with one entry per pass."""
    passes = build_pass_program(p)
    fused = []
    i = 0
    while i < len(passes):
        ps = passes[i]
        if ps.kind == "count":
            assert passes[i + 1].kind == "lprsum"
            seed = passes[i + 2]
            assert seed.kind == "fitseed"
            fused.append(
                (K_SEEDFIT, ps.peel_snap, seed.snap_slot,
                 int(seed.gate_alive), 0, seed.th)
            )
            i += 3
        else:
            assert ps.kind == "fitdist"
            fused.append(
                (K_FITDIST, -1, -1, int(ps.gate_alive), int(ps.is_final), ps.th)
            )
            i += 1
    kind, peel, snap, gate_alive, final, th = map(np.array, zip(*fused))
    return (
        len(fused),
        kind.astype(np.int32), peel.astype(np.int32), snap.astype(np.int32),
        gate_alive.astype(np.int32), final.astype(np.int32),
        th.astype(np.float32),
    )


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/fit_grid.cu (once per source content) and load it."""
    return nvcc.build(SOURCE, "ppk_fit_grid", ARGTYPES)


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


@functools.lru_cache(maxsize=None)
def _program(params: Params, device: torch.device) -> torch.Tensor:
    """The pass program as one (6, npasses) int32 device tensor: kind, peel
    slot, snapshot slot, gate_alive, final, and the threshold's f32 bits.
    Kept for the life of the process: a captured frame's graph reads it
    through the pointer of its capture (``graphs.py``), so it must never
    be freed or made again."""
    npasses, kind, peel, snap, gate_alive, final, th = _pass_config(params)
    rows = np.stack([kind, peel, snap, gate_alive, final, th.view(np.int32)])
    return torch.as_tensor(rows, device=device).contiguous()


def fused_fit_grid(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts, params: Params,
):
    """Per-patch fit table of the tiled cloud.

    Args:
      xs, ys, zs, valid_f: (NT, 128) f32 tiled point data; ``valid_f``
        holds only 0 and 1 (the kernel keeps ``active`` as one bit a row).
      tile_patch: (NT,) or (NT, 1) int32 patch of each tile (read by the
        plain version; the kernel finds each patch's tiles from pad_start).
      pad_start: (S+1,) int32 tile-aligned run starts.
      gates: (S, 8) f32 [processed, shift_x, shift_y, shift_z, zone0, 0..];
        ``processed`` is 0 or 1.
      consts: (8,) f32 [margin_thr, 0..].

    Returns:
      (S, out_cols) f32 table (``tiled_fit.out_layout``).
    """
    from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit

    if xs.device.type == "cpu":
        return tiled_fit(
            xs, ys, zs, valid_f, tile_patch, pad_start, gates, consts[0], params
        )
    if xs.device.type != "cuda":
        raise ValueError(f"fit kernel runs on CUDA or CPU tensors, not {xs.device}")

    out = launch_fit_program(
        build().ppk_fit_grid, "K1",
        xs, ys, zs, valid_f, pad_start, gates, consts, params,
    )
    fused_fit_grid.launches += 1
    return out


def launch_fit_program(
    entry, label, xs, ys, zs, valid_f, pad_start, gates, consts, params: Params,
):
    """Check the CUDA tensors, allocate the table and the active-bit scratch
    and call a fit kernel's C entry point (``ppk_fit_grid`` or
    ``ppk_fit_onehot``, :data:`~patchworkpp_tpu_torch.ops.fit_kernel.ARGTYPES`)
    on the current stream. Returns the (spad, out_cols) table."""
    from patchworkpp_tpu_torch.ops.tiled_fit import out_layout

    dev = xs.device
    nt = xs.shape[0]
    spad = gates.shape[0]
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs), ("valid_f", valid_f)):
        nvcc.check(name, t, torch.float32, (nt, LANE), dev)
    nvcc.check("pad_start", pad_start, torch.int32, (spad + 1,), dev)
    nvcc.check("gates", gates, torch.float32, (spad, 8), dev)
    nvcc.check("consts", consts, torch.float32, (8,), dev)
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        if t.data_ptr() % 16:  # the row copy's float4 loads
            raise ValueError(f"{name} must be 16-byte aligned")

    prog = _program(params, dev)
    snap_off, carry2_off, out_cols = out_layout(params)
    out = torch.empty((spad, out_cols), dtype=torch.float32, device=dev)
    # active bits of patches longer than CAP_TILES (the others keep theirs
    # in shared memory)
    mask = torch.empty((nt, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(
        xs.data_ptr(), ys.data_ptr(), zs.data_ptr(), valid_f.data_ptr(),
        pad_start.data_ptr(), gates.data_ptr(), consts.data_ptr(),
        prog.data_ptr(), prog.shape[1],
        mask.data_ptr(), out.data_ptr(),
        nt, spad, out_cols, snap_off, carry2_off, params.num_lpr,
        f32(params.th_dist_v), f32(params.uprightness_thr),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"fit kernel {label} launch failed: CUDA error {rc}")
    return out


# Launches of the CUDA kernel (plain-version calls do not count).
fused_fit_grid.launches = 0
