"""Flagship model: stateful Patchwork++ engine over the frame step (port of
``patchworkpp_tpu/models/patchworkpp.py``; reference ``PatchWorkpp`` class,
cpp/patchworkpp/include/patchwork/patchworkpp.h:114-235).

NumPy in / NumPy out. The frame runs on ``device`` ("cuda" by default) and
the adaptive state stays there between frames, in static buffers that each
frame updates in place. On the card the frame of every engine, chunked or
not, is a captured CUDA graph, one per (RNR setting, capacity), as the JAX
facade jits one (``graphs.py``); the CPU runs the same static-buffer step
eagerly. A scan is uploaded as the 8192-row bucket
that holds its rows and zero-extended to the capacity on the device; each
frame's result, or each run of frames', comes back to the host in one
device -> host copy of one packed buffer.

Each step records spans (``utils/profiling.py``): ``facade.step`` (whose
duration is ``time_taken_s``) and inside it ``facade.stage`` (the NumPy
stack), ``facade.upload`` (host -> device copy and zero-extension), the
frame's ``dispatch.launch`` (``graphs.py``), ``facade.readback`` (the
packed copy back, the host waiting for the device) and ``facade.unpack``
(the host's unpacking and index building); on the card each replay's
device time is a ``frame.span``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from patchworkpp_tpu_torch.device import resolve_device
from patchworkpp_tpu_torch.graphs import CapturedFrame
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.pipeline import FrameResult, make_frame_fn
from patchworkpp_tpu_torch.state import AdaptiveState, init_state
from patchworkpp_tpu_torch.utils import profiling

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


class SegmentationResult(NamedTuple):
    """Per-frame result trimmed to the real point count, original row order."""

    ground_mask: np.ndarray        # (N,) bool
    ground_indices: np.ndarray     # (G,) int32, ascending
    nonground_indices: np.ndarray  # (N-G,) int32, ascending
    centers: np.ndarray            # (K, 3) per-processed-patch plane centroids
    normals: np.ndarray            # (K, 3) per-processed-patch plane normals
    time_taken_s: float            # host wall time of the frame step (facade.step)


def _round_capacity(n: int, quantum: int = 8192) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def _pack_result(res: FrameResult) -> torch.Tensor:
    """Everything SegmentationResult needs as ONE uint8 buffer on the
    device, in the JAX package's byte layout: the ground mask bit-packed 8
    labels a byte (little bit order, the flattened mask padded to a multiple
    of 8), ``num_ground`` as int32, the patch means and normals as f32
    bytes and the processed flags one byte each. Leading batch dimensions
    (a sequence's results) are flattened into each field."""
    flat = res.ground_mask.reshape(-1)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=flat.device)
    packed = (flat.reshape(-1, 8).to(torch.int32) * weights).sum(dim=1)
    return torch.cat([
        packed.to(torch.uint8),
        _bytes(res.num_ground.reshape(-1).to(torch.int32)),
        _bytes(res.patch_mean.to(torch.float32)),
        _bytes(res.patch_normal.to(torch.float32)),
        res.patch_processed.reshape(-1).to(torch.uint8),
    ])


def _unpack_result(buf: np.ndarray, res: FrameResult):
    """Host-side inverse of :func:`_pack_result` (shapes read off the
    device FrameResult, no data). Returns (mask, num_ground, patch_mean,
    patch_normal, patch_processed) with the FrameResult's leading batch
    dimensions."""
    shape = tuple(res.ground_mask.shape)
    nmask = int(np.prod(shape))
    off = (nmask + 7) // 8
    mask = np.unpackbits(buf[:off], bitorder="little")[:nmask].astype(bool).reshape(shape)
    ng_shape = tuple(res.num_ground.shape)
    k = 4 * int(np.prod(ng_shape))
    num_ground = buf[off:off + k].copy().view(np.int32).reshape(ng_shape)
    off += k
    out = []
    for f in (res.patch_mean, res.patch_normal):
        k = 4 * int(np.prod(tuple(f.shape)))
        out.append(buf[off:off + k].copy().view(np.float32).reshape(tuple(f.shape)))
        off += k
    proc_shape = tuple(res.patch_processed.shape)
    proc = buf[off:off + int(np.prod(proc_shape))].astype(bool).reshape(proc_shape)
    return mask, num_ground, out[0], out[1], proc


def _zero_extend(a: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-extend the row axis (axis -2) of ``a`` to ``cap`` on its device:
    the bucketed upload of a frame ((rows, 4)) or a sequence ((B, rows, 4))."""
    if a.shape[-2] == cap:
        return a
    pad = a.new_zeros(a.shape[:-2] + (cap - a.shape[-2], a.shape[-1]))
    return torch.cat([a, pad], dim=-2)


def _result(mask, means, normals, proc, n) -> SegmentationResult:
    """The result of one frame; ``time_taken_s`` is set once the step that
    built it has ended."""
    mask = mask[:n]
    return SegmentationResult(
        ground_mask=mask,
        ground_indices=np.flatnonzero(mask).astype(np.int32),
        nonground_indices=np.flatnonzero(~mask).astype(np.int32),
        centers=means[proc],
        normals=normals[proc],
        time_taken_s=0.0,
    )


class PatchworkPP:
    """Stateful ground segmentation of one LiDAR stream.

    ``device`` defaults to "cuda"; without CUDA, construction raises and
    the caller passes ``device="cpu"`` to run the plain PyTorch path.
    ``capacity`` fixes the padded row count; by default each scan is padded
    to the next multiple of 8192 rows. ``fused`` picks the engine
    (``pipeline.make_frame_fn``): None/"tiled", True/"grid" and
    "grid_iota" run the fit kernel K1, "onehot" the unrolled fit kernel K2,
    False the unfused engine (its per-patch sums the kernel KR).
    ``chunks`` = K > 1 runs each frame as K row blocks on the device
    (``parallel/chunked.py``: the point-sharded program's emulation, not a
    speed lever; "tiled" or False only, and the tiled fit then runs the
    sharded fit kernel KS, not K1); the capacity must then be a multiple of
    K (a fixed one that is not raises; the automatic one rounds up to a
    multiple of lcm(8192, K)).
    """

    def __init__(
        self,
        params: Optional[Params] = None,
        capacity: Optional[int] = None,
        device: Optional[str] = None,
        fused=None,
        chunks: int = 1,
    ) -> None:
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        device = resolve_device(device or "cuda", "PatchworkPP")
        self.device = device
        self.params = params or Params()
        self.geom = CZMGeometry.create(self.params)
        self._fixed_capacity = capacity
        self._fused = fused
        self._chunks = chunks
        # (enable_rnr, capacity, captured) -> the frame over the state buffers
        self._frames = {}
        # every engine on the card runs captured; the CPU runs the same step
        # eagerly
        self._capture = device.type == "cuda"
        self._state = init_state(self.params, device)
        self.last_result: Optional[FrameResult] = None

    # ------------------------------------------------------------------ state

    @property
    def state(self) -> AdaptiveState:
        """A copy of the adaptive state (the frames update their buffers in
        place). Assigning a state copies it into those buffers."""
        return self._state.clone()

    @state.setter
    def state(self, state: AdaptiveState) -> None:
        self._state.copy_(state)

    def reset(self) -> None:
        self.state = init_state(self.params, self.device)

    def save_state(self, path: str) -> None:
        self._state.save(path)

    def load_state(self, path: str) -> None:
        self.state = AdaptiveState.load(path, self.device)

    @property
    def sensor_height(self) -> float:
        """Adapted sensor height (reference getHeight(), patchworkpp.h:154)."""
        return float(self._state.sensor_height)

    # ------------------------------------------------------------------ run

    def _capacity(self, n: int) -> int:
        """The padded capacity of an n-point scan: the fixed one, else the
        next multiple of 8192, rounded up to a multiple of lcm(8192, chunks)
        where ``chunks`` does not divide it (JAX
        ``models/patchworkpp.py:_capacity``)."""
        cap = self._fixed_capacity or _round_capacity(n)
        if cap % self._chunks:
            if self._fixed_capacity:
                raise ValueError(f"capacity {cap} not divisible by chunks={self._chunks}")
            q = math.lcm(8192, self._chunks)
            cap = -(-cap // q) * q
        if n > cap:
            raise ValueError(f"scan has {n} points > fixed capacity {cap}")
        return cap

    def _frame(self, enable_rnr: bool, cap: int, captured: Optional[bool] = None
               ) -> CapturedFrame:
        """The frame of this engine with RNR on or off at capacity ``cap``
        over the state buffers (JAX ``_get_fn``'s key), built once: captured
        on the card unless ``captured`` is False (the profiled frame)."""
        captured = self._capture if captured is None else captured
        key = (enable_rnr, cap, captured)
        cf = self._frames.get(key)
        if cf is None:
            p = self.params if enable_rnr == self.params.enable_RNR else (
                self.params.replace(enable_RNR=enable_rnr)
            )
            if self._chunks > 1:
                from patchworkpp_tpu_torch.parallel.chunked import chunked_step

                frame = chunked_step(p, self._chunks, self.geom, self._fused, self.device)
            else:
                frame = make_frame_fn(p, self.geom, self.device, fused=self._fused)
            cf = CapturedFrame(frame, cap, self._state)
            if captured:
                cf.capture()
            self._frames[key] = cf
        return cf

    @staticmethod
    def _check_cloud(cloud) -> np.ndarray:
        cloud = np.asarray(cloud, np.float32)
        if cloud.ndim != 2 or cloud.shape[1] not in (3, 4):
            raise ValueError(f"cloud must be (N,3) or (N,4); got {cloud.shape}")
        return cloud

    def _rnr(self, cloud: np.ndarray) -> bool:
        # RNR needs intensity: off for a 3-column cloud, as the reference
        # refuses RNR without 4 columns (patchworkpp.cpp:379)
        return self.params.enable_RNR and cloud.shape[1] >= 4

    def _upload(self, clouds, cap: int) -> torch.Tensor:
        """Stack ``clouds`` zero-padded into the 8192-row bucket that holds
        the longest, upload it and zero-extend it to ``cap`` on the device
        (padding rows are zeros either way: the same input, fewer bytes
        moved when the scans sit below the capacity)."""
        with profiling.span("facade.stage", scans=len(clouds), host_only=True):
            rows = min(cap, _round_capacity(max(max(c.shape[0] for c in clouds), 1)))
            stack = np.zeros((len(clouds), rows, 4), np.float32)
            for i, c in enumerate(clouds):
                stack[i, : c.shape[0], : c.shape[1]] = c
        with profiling.span("facade.upload", scans=len(clouds)):
            return _zero_extend(torch.from_numpy(stack).to(self.device), cap)

    def _readback(self, res: FrameResult) -> np.ndarray:
        """The one device -> host copy of a frame's or a run's results, as
        the packed host buffer that :func:`_unpack_result` reads."""
        mask = res.ground_mask
        with profiling.span("facade.readback", scans=mask.shape[0] if mask.dim() > 1 else 1):
            return _pack_result(res).cpu().numpy()

    def estimate_ground(self, cloud: np.ndarray) -> SegmentationResult:
        """Segment one scan. ``cloud`` is (N, 3) or (N, 4) float32."""
        return self._estimate(cloud)

    def _estimate(self, cloud: np.ndarray, captured: Optional[bool] = None
                  ) -> SegmentationResult:
        cloud = self._check_cloud(cloud)
        n = cloud.shape[0]
        cap = self._capacity(n)
        cf = self._frame(self._rnr(cloud), cap, captured)
        step = profiling.span("facade.step", timed=True)
        with step:
            x = self._upload([cloud], cap)[0]
            res = cf(x, n)
            buf = self._readback(res)
            self.last_result = res
            with profiling.span("facade.unpack", host_only=True):
                mask, num_ground, means, normals, proc = _unpack_result(buf, res)
                out = _result(mask, means, normals, proc, n)
        if self.params.verbose:
            print(
                f"patchworkpp_tpu_torch: {n} pts -> {int(num_ground)} ground "
                f"in {step.seconds * 1e3:.2f} ms (sensor_height={self.sensor_height:.4f})"
            )
        return out._replace(time_taken_s=step.seconds)

    def estimate_ground_sequence(self, clouds) -> list:
        """Segment an ordered batch of scans, the state threaded through
        them: equal to calling :meth:`estimate_ground` on each in order,
        with one capacity for the whole batch (that of its longest scan).

        RNR gates per cloud as in :meth:`estimate_ground`, so a batch that
        mixes 3- and 4-column scans runs as consecutive uniform runs. Each
        run replays the frame of :meth:`estimate_ground` once a scan (on the
        card one captured graph, whatever the run's length) and ends in one
        packed readback; ``time_taken_s`` holds the run's wall time on its
        first entry and 0.0 on the rest."""
        clouds = [self._check_cloud(c) for c in clouds]
        if not clouds:
            return []
        cap = self._capacity(max(c.shape[0] for c in clouds))
        out: list = []
        run: list = []
        for c in clouds:
            if run and self._rnr(c) != self._rnr(run[0]):
                out.extend(self._run_sequence(run, cap))
                run = []
            run.append(c)
        out.extend(self._run_sequence(run, cap))
        return out

    def _run_sequence(self, clouds, cap: int) -> list:
        cf = self._frame(self._rnr(clouds[0]), cap)
        npts = [c.shape[0] for c in clouds]
        step = profiling.span("facade.step", scans=len(clouds), timed=True)
        with step:
            x = self._upload(clouds, cap)
            res = cf.sequence(x, npts)
            buf = self._readback(res)
            self.last_result = FrameResult(*(f[-1] for f in res))
            with profiling.span("facade.unpack", scans=len(clouds), host_only=True):
                masks, _, means, normals, procs = _unpack_result(buf, res)
                out = [_result(masks[i], means[i], normals[i], procs[i], n)
                       for i, n in enumerate(npts)]
        out[0] = out[0]._replace(time_taken_s=step.seconds)
        return out

    # ------------------------------------------------------------- profiling

    def profile_stages(self, cloud: np.ndarray, frames: int = 3):
        """Per-stage time of the frame (the verbose analog of the
        reference's czm/sort/pca/gle clock() split, patchworkpp.cpp:320-333):
        ``frames`` calls of :meth:`estimate_ground` under ``torch.profiler``,
        aggregated by the pipeline's ``stage_*`` ranges. On the card a
        stage's time is the device time of the kernels inside its range; on
        the CPU, the range's host time. The profiled frame runs eagerly (a
        graph replay has no ranges), on the same state. Returns (stage ->
        seconds total, top-op table); divide by ``frames`` for per-frame
        numbers. The state advances by ``frames`` + 1 frames (one untraced
        warm-up)."""
        from patchworkpp_tpu_torch.utils.roofline import format_report, profile_frames

        cloud = self._check_cloud(cloud)
        self._estimate(cloud, captured=False)  # builds and warms outside the trace

        def run():
            for _ in range(frames):
                self._estimate(cloud, captured=False)  # ends in its readback (a sync)

        stages, ops = profile_frames(run)
        if self.params.verbose:
            print(format_report(stages, frames, header="per-stage time:"))
        return stages, ops
