"""The label replay kernel KL: the frame tail's per-point labels, in the
points' original order, from the per-patch label table, as one CUDA launch.

No TPU kernel is replaced: the JAX package's replay is XLA
(``patchworkpp_tpu/pipeline.py`` ``_finalize``'s ``_replay``). The source is
``csrc/label_replay.cu``, built by ``ops/nvcc.py`` at the first call. Its
plain version is :func:`label_replay_reference`, the PyTorch loop the frame
ran before, which it equals bit for bit: the same float32 operations (each
distance ``ops.plane_dist``; its once-rounded fused multiply-adds are the
kernel's ``__fmaf_rn``) and the same tests. The launch reads nothing back to
the host, so a captured frame holds it as one node (with the count's
zeroing before it) where the plain version ran ~190 float64 tensor ops a
65536-row block.

:func:`label_replay` runs the kernel on a CUDA tensor and the plain version
on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from patchworkpp_tpu_torch.ops import nvcc, plane_dist

SOURCE = nvcc.CSRC / "label_replay.cu"
# The label table's columns: the final plane [nx, ny, nz, d], the patch's
# code (2 processed + 1 ground), then each R-VPF snapshot's plane.
PLANE_COLS = 4
FIRST_SNAPSHOT_COL = 5
# ppk_label_replay's parameters, in order:
# points ld patch_id num_rows table num_patches cols th_dist th_dist_v ground num_ground stream
ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p)
# ppk_label_replay_launches's: host reset
LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_int)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/label_replay.cu (once per source content) and load it."""
    lib = nvcc.build(SOURCE, "ppk_label_replay", ARGTYPES)
    lib.ppk_label_replay_launches.argtypes = list(LAUNCH_ARGTYPES)
    lib.ppk_label_replay_launches.restype = ctypes.c_int
    return lib


def kernel_launches(reset: bool = False) -> int:
    """KL's launches as the kernel counted them on the card (the grid's
    first thread adds one; a replayed graph's launch counts too) since the
    library was loaded or last reset; ``reset`` zeroes the count after the
    read. Waits for the device."""
    count = ctypes.c_ulonglong(0)
    rc = build().ppk_label_replay_launches(ctypes.cast(ctypes.byref(count), ctypes.c_void_p),
                                           int(reset))
    if rc != 0:
        raise RuntimeError(f"label replay kernel KL: reading its launch count failed: CUDA "
                           f"error {rc}")
    return int(count.value)


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


def snapshots(label_tab: torch.Tensor) -> int:
    """The R-VPF snapshot planes a label table holds (its columns past the
    code, four a plane); raises on a width that is not 5 + 4 R."""
    cols = label_tab.shape[-1]
    if label_tab.dim() != 2 or cols < FIRST_SNAPSHOT_COL or (cols - FIRST_SNAPSHOT_COL) % 4:
        raise ValueError(f"label_tab must be (S, 5 + 4 R), got shape {tuple(label_tab.shape)}")
    return (cols - FIRST_SNAPSHOT_COL) // PLANE_COLS


def label_replay_reference(points: torch.Tensor, patch_id: torch.Tensor, label_tab: torch.Tensor,
                           th_dist: float, th_dist_v: float):
    """The plain version: ``(ground_mask, num_ground)`` as the frame's tail
    computed them in PyTorch, in ``pipeline._REPLAY_BLOCK``-row blocks (a
    block's gathered (rows, C) table is what it materializes)."""
    from patchworkpp_tpu_torch import pipeline

    dev = points.device
    x_o, y_o, z_o = points[:, 0], points[:, 1], points[:, 2]
    num_snaps = snapshots(label_tab)

    def _replay(pid_b, xb, yb, zb):
        # a gather (the JAX package's one-hot MXU lookup, ops/onehot.py,
        # returns the same bits)
        lk = label_tab[pid_b]

        def _plane_dist(c0):
            return plane_dist(xb, yb, zb, lk[:, c0], lk[:, c0 + 1],
                              lk[:, c0 + 2], lk[:, c0 + 3])

        dist_o = _plane_dist(0)
        peeled = torch.zeros(pid_b.shape[0], dtype=torch.bool, device=dev)
        for it in range(num_snaps):
            peeled = peeled | (
                torch.abs(_plane_dist(5 + 4 * it)) < th_dist_v
            )
        return (
            (lk[:, 4] > 1.5)
            & ~peeled
            & (dist_o < th_dist)
            & (lk[:, 4] > 2.5)
        )

    pid_l = patch_id.to(torch.int64)
    blk = pipeline._REPLAY_BLOCK
    ground = torch.cat([
        _replay(pid_l[s:s + blk], x_o[s:s + blk], y_o[s:s + blk], z_o[s:s + blk])
        for s in range(0, pid_l.shape[0], blk)
    ])
    return ground, torch.sum(ground).to(torch.int32)


def label_replay(points: torch.Tensor, patch_id: torch.Tensor, label_tab: torch.Tensor,
                 th_dist: float, th_dist_v: float):
    """Each point's label and the count of ground points: ``(ground_mask``
    (P,) bool, ``num_ground`` () int32``)``.

    ``points`` (P, >= 3) f32 (x, y, z in its first three columns; each row
    contiguous), ``patch_id`` (P,) int32 rows of ``label_tab`` (S, 5 + 4 R)
    f32, whose columns are a patch's final plane [nx, ny, nz, d], its code
    and its R R-VPF snapshot planes (``pipeline._finalize`` builds it; a
    shut snapshot holds the sentinel plane). A point is ground where its
    patch's code is above 2.5, its distance to the final plane below
    ``th_dist`` and to no snapshot plane below ``th_dist_v`` in magnitude
    (both float32 values). The binning gives every point a row; an id
    outside [0, S) labels its point non-ground on the card, where the plain
    version's gather raises.

    On a CUDA tensor: one launch of KL on the current stream (and the
    count's zeroing), counted in ``label_replay.launches``. On a CPU tensor:
    :func:`label_replay_reference`, not counted. Raises, on any device, on a
    dtype, shape or device the kernel does not take; on a device other
    than the CPU and CUDA; and on a failed build or launch."""
    dev = points.device
    if points.dim() != 2 or points.shape[1] < 3 or points.stride(1) != 1:
        raise ValueError(f"points must be (P, >= 3) with contiguous rows, got shape "
                         f"{tuple(points.shape)}, strides {points.stride()}")
    if points.dtype != torch.float32:
        raise ValueError(f"points has dtype {points.dtype}, expected {torch.float32}")
    p = points.shape[0]
    snapshots(label_tab)
    if label_tab.shape[0] < 1:
        raise ValueError("label_tab has no rows")
    nvcc.check("patch_id", patch_id, torch.int32, (p,), dev)
    nvcc.check("label_tab", label_tab, torch.float32, tuple(label_tab.shape), dev)
    if dev.type == "cpu":
        return label_replay_reference(points, patch_id, label_tab, th_dist, th_dist_v)
    if dev.type != "cuda":
        raise ValueError(f"the label replay kernel KL runs on CUDA tensors, not {dev}; on the "
                         "CPU label_replay runs label_replay_reference")
    s, cols = label_tab.shape
    ground = torch.empty(p, dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build().ppk_label_replay(points.data_ptr(), points.stride(0), patch_id.data_ptr(), p,
                                  label_tab.data_ptr(), s, cols, th_dist, th_dist_v,
                                  ground.data_ptr(), count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"label replay kernel KL launch failed: CUDA error {rc}")
    label_replay.launches += 1
    return ground, count


# Calls of the CUDA kernel (plain-version calls do not count).
label_replay.launches = 0
