"""Flagship model: stateful Patchwork++ engine over the frame step (port of
``patchworkpp_tpu/models/patchworkpp.py``; reference ``PatchWorkpp`` class,
cpp/patchworkpp/include/patchwork/patchworkpp.h:114-235).

NumPy in / NumPy out. The frame runs on ``device`` ("cuda" by default) and
the adaptive state stays there between frames; each frame's result comes
back to the host in one device -> host copy.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.pipeline import FrameResult, make_frame_fn
from patchworkpp_tpu_torch.state import AdaptiveState, init_state


class SegmentationResult(NamedTuple):
    """Per-frame result trimmed to the real point count, original row order."""

    ground_mask: np.ndarray        # (N,) bool
    ground_indices: np.ndarray     # (G,) int32, ascending
    nonground_indices: np.ndarray  # (N-G,) int32, ascending
    centers: np.ndarray            # (K, 3) per-processed-patch plane centroids
    normals: np.ndarray            # (K, 3) per-processed-patch plane normals
    time_taken_s: float            # host wall time of the frame step


def _round_capacity(n: int, quantum: int = 8192) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def _pack_result(res: FrameResult) -> torch.Tensor:
    """Everything SegmentationResult needs as ONE uint8 buffer on the
    device: the mask (one byte a row), patch means and normals (f32 bytes)
    and the processed flags, so the frame costs one device -> host copy."""
    return torch.cat([
        res.ground_mask.to(torch.uint8),
        res.patch_mean.contiguous().view(torch.uint8).reshape(-1),
        res.patch_normal.contiguous().view(torch.uint8).reshape(-1),
        res.patch_processed.to(torch.uint8),
    ])


def _unpack_result(buf: np.ndarray, rows: int, npatch: int):
    """Host-side inverse of :func:`_pack_result`:
    (mask, patch_mean, patch_normal, patch_processed)."""
    mask = buf[:rows].astype(bool)
    off = rows
    k = npatch * 3 * 4
    means = buf[off:off + k].view(np.float32).reshape(npatch, 3)
    normals = buf[off + k:off + 2 * k].view(np.float32).reshape(npatch, 3)
    proc = buf[off + 2 * k:].astype(bool)
    return mask, means, normals, proc


def _result(mask, means, normals, proc, n, dt) -> SegmentationResult:
    mask = mask[:n]
    return SegmentationResult(
        ground_mask=mask,
        ground_indices=np.flatnonzero(mask).astype(np.int32),
        nonground_indices=np.flatnonzero(~mask).astype(np.int32),
        centers=means[proc],
        normals=normals[proc],
        time_taken_s=dt,
    )


class PatchworkPP:
    """Stateful ground segmentation of one LiDAR stream.

    ``device`` defaults to "cuda"; without CUDA, construction raises and
    the caller passes ``device="cpu"`` to run the plain PyTorch path.
    ``capacity`` fixes the padded row count; by default each scan is padded
    to the next multiple of 8192 rows. ``fused`` picks the engine
    (``pipeline.make_frame_fn``): None/"tiled", True/"grid" and
    "grid_iota" run the fit kernel K1, "onehot" the unrolled fit kernel K2,
    False the unfused engine.
    """

    def __init__(
        self,
        params: Optional[Params] = None,
        capacity: Optional[int] = None,
        device: Optional[str] = None,
        fused=None,
    ) -> None:
        device = torch.device(device or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PatchworkPP runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        self.device = device
        self.params = params or Params()
        self.geom = CZMGeometry.create(self.params)
        self._fixed_capacity = capacity
        self._fused = fused
        self._fns = {}  # enable_rnr -> frame fn
        self.state = init_state(self.params, device)
        self.last_result: Optional[FrameResult] = None

    # ------------------------------------------------------------------ state

    def reset(self) -> None:
        self.state = init_state(self.params, self.device)

    def save_state(self, path: str) -> None:
        self.state.save(path)

    def load_state(self, path: str) -> None:
        self.state = AdaptiveState.load(path, self.device)

    @property
    def sensor_height(self) -> float:
        """Adapted sensor height (reference getHeight(), patchworkpp.h:154)."""
        return float(self.state.sensor_height)

    # ------------------------------------------------------------------ run

    def _capacity(self, n: int) -> int:
        cap = self._fixed_capacity or _round_capacity(n)
        if n > cap:
            raise ValueError(f"scan has {n} points > fixed capacity {cap}")
        return cap

    def _frame_fn(self, enable_rnr: bool):
        fn = self._fns.get(enable_rnr)
        if fn is None:
            p = self.params if enable_rnr == self.params.enable_RNR else (
                self.params.replace(enable_RNR=enable_rnr)
            )
            fn = make_frame_fn(p, self.geom, self.device, fused=self._fused)
            self._fns[enable_rnr] = fn
        return fn

    @staticmethod
    def _check_cloud(cloud) -> np.ndarray:
        cloud = np.asarray(cloud, np.float32)
        if cloud.ndim != 2 or cloud.shape[1] not in (3, 4):
            raise ValueError(f"cloud must be (N,3) or (N,4); got {cloud.shape}")
        return cloud

    def _run(self, cloud: np.ndarray, cap: int):
        """One frame: upload, step, one packed readback."""
        n = cloud.shape[0]
        # RNR needs intensity: off for a 3-column cloud, as the reference
        # refuses RNR without 4 columns (patchworkpp.cpp:379)
        fn = self._frame_fn(self.params.enable_RNR and cloud.shape[1] >= 4)
        padded = np.zeros((cap, 4), np.float32)
        padded[:n, : cloud.shape[1]] = cloud
        t0 = time.perf_counter()
        x = torch.from_numpy(padded).to(self.device)
        new_state, res = fn(self.state, x, n)
        buf = _pack_result(res).cpu().numpy()
        dt = time.perf_counter() - t0
        self.state = new_state
        self.last_result = res
        mask, means, normals, proc = _unpack_result(
            buf, cap, self.geom.num_patches
        )
        if self.params.verbose:
            print(
                f"patchworkpp_tpu_torch: {n} pts -> {int(mask[:n].sum())} "
                f"ground in {dt * 1e3:.2f} ms"
            )
        return _result(mask, means, normals, proc, n, dt)

    def estimate_ground(self, cloud: np.ndarray) -> SegmentationResult:
        """Segment one scan. ``cloud`` is (N, 3) or (N, 4) float32."""
        cloud = self._check_cloud(cloud)
        return self._run(cloud, self._capacity(cloud.shape[0]))

    def estimate_ground_sequence(self, clouds) -> list:
        """Segment an ordered batch of scans, the state threaded through
        them: equal to calling :meth:`estimate_ground` on each in order,
        with one capacity for the whole batch (that of its longest scan)."""
        clouds = [self._check_cloud(c) for c in clouds]
        if not clouds:
            return []
        cap = self._capacity(max(c.shape[0] for c in clouds))
        return [self._run(c, cap) for c in clouds]
