"""Flagship model: stateful Patchwork++ engine over the frame step (port of
``patchworkpp_tpu/models/patchworkpp.py``; reference ``PatchWorkpp`` class,
cpp/patchworkpp/include/patchwork/patchworkpp.h:114-235).

NumPy in / NumPy out. The frame runs on ``device`` ("cuda" by default) and
the adaptive state stays there between frames, in static buffers that each
frame updates in place. On the card the frame of every engine, chunked or
not, is a captured CUDA graph, one per (RNR setting, capacity), as the JAX
facade jits one (``graphs.py``); the CPU runs the same static-buffer step
eagerly. A single scan is uploaded as the 8192-row bucket that holds its
rows and zero-extended to the capacity on the device, and its result comes
back to the host in one device -> host copy of one packed buffer.

A sequence runs as a pipeline, scan by scan, through buffers kept across
calls (:class:`_Slots`; page-locked on the card, so that neither copy
waits for the host): each scan is staged into its host slot, copied to its
device slot, replayed, and its packed result copied back into its host
readback slot behind an event, all without waiting; then the host waits on
each scan's event in order and unpacks it. So while the card replays scan
i, the host stages scan i+1, and the early scans are unpacked while the
later ones run. On the CPU the same loop runs synchronously.

Each step records spans (``utils/profiling.py``): ``facade.step`` (whose
duration is ``time_taken_s``) and inside it one each of ``facade.stage``
(the host staging), ``facade.upload`` (host -> device copy, and for a
single scan the zero-extension), the frame's ``dispatch.launch``,
``facade.readback`` (the packing, the copy back and the host's wait for
the device) and ``facade.unpack`` (the host's unpacking and index
building); in a sequence each is its phase's time summed over the scans
(``profiling.phase``). On the card each replay's device time is a
``frame.span``, and ``facade.overlapped_scans`` counts the scans staged
while the step's previous scan was still on the card. Where the frame
carries planes across empty patches (``num_min_pts`` 0,
``pipeline.carry_planes``), its count of inherited planes rides at the end
of the packed readback, and the counter ``frame.inherited_planes`` sums it
over the scans unpacked.
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


def _pack_result(res: FrameResult, weights: Optional[torch.Tensor] = None,
                 inherited: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Everything SegmentationResult needs as ONE uint8 buffer on the
    device, in the JAX package's byte layout: the ground mask bit-packed 8
    labels a byte (little bit order, the flattened mask padded to a multiple
    of 8), ``num_ground`` as int32, the patch means and normals as f32
    bytes and the processed flags one byte each. Leading batch dimensions
    (a sequence's results) are flattened into each field. ``weights``: the
    bit weights already on the device (made here otherwise, by a host ->
    device copy that waits for the stream). ``inherited``: a frame's 0-d
    int32 count of inherited planes, appended as 4 more bytes
    (:func:`_unpack_inherited`)."""
    flat = res.ground_mask.reshape(-1)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    if weights is None:
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=flat.device)
    packed = (flat.reshape(-1, 8).to(torch.int32) * weights).sum(dim=1)
    extra = [] if inherited is None else [_bytes(inherited.reshape(1))]
    return torch.cat([
        packed.to(torch.uint8),
        _bytes(res.num_ground.reshape(-1).to(torch.int32)),
        _bytes(res.patch_mean.to(torch.float32)),
        _bytes(res.patch_normal.to(torch.float32)),
        res.patch_processed.reshape(-1).to(torch.uint8),
        *extra,
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


def _unpack_inherited(buf: np.ndarray) -> int:
    """The count of inherited planes that :func:`_pack_result` appended."""
    return int(buf[-4:].copy().view(np.int32)[0])


def _zero_extend(a: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero-extend the row axis (axis -2) of ``a`` to ``cap`` on its device:
    the bucketed upload of a frame ((1, rows, 4))."""
    if a.shape[-2] == cap:
        return a
    pad = a.new_zeros(a.shape[:-2] + (cap - a.shape[-2], a.shape[-1]))
    return torch.cat([a, pad], dim=-2)


def _copy_rows(dst: torch.Tensor, src: torch.Tensor, rows: int, non_blocking: bool) -> None:
    """Copy the leading ``rows`` rows of ``src`` into ``dst`` (a slot's
    upload)."""
    dst[:rows].copy_(src[:rows], non_blocking=non_blocking)


class _Slots:
    """The sequence path's buffers, kept by the facade across calls and
    grown to the longest run and the largest capacity it meets: a (B,
    rows, 4) float32 host staging buffer and a device buffer of the same
    shape, a (B, L) uint8 host readback buffer for the packed results and,
    on the card, one event a slot. On the card the host buffers are
    page-locked, so that a copy neither waits for the stream to reach it
    nor blocks the host.

    ``rows[i]`` counts the leading rows of slot i that may be nonzero, on
    both sides: staging a shorter scan zeroes the host rows the last one
    left, and the upload copies as many rows as either scan held, so every
    row of a slot past its scan's is zero on the device, as the frame's
    padding must be. A slot is written once a call; a call starts once the
    last one's copies have ended (its events waited, or the stream drained
    where it failed)."""

    def __init__(self, b: int, rows: int, device: torch.device) -> None:
        self.device = device
        self.pinned = device.type == "cuda"
        self.host = torch.zeros((b, rows, 4), dtype=torch.float32, pin_memory=self.pinned)
        self._host = self.host.numpy()
        self.dev = torch.zeros((b, rows, 4), dtype=torch.float32, device=device)
        self.rows = [0] * b
        self.weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=device)
        self.events = [torch.cuda.Event() for _ in range(b)] if self.pinned else None
        self.back = None  # (b, L) uint8, made for the packed length at a call's first scan
        self._back = None

    def fits(self, b: int, rows: int) -> bool:
        return b <= len(self.rows) and rows <= self.host.shape[1]

    def busy(self, i: int) -> bool:
        """Slot i's scan is still on the card (a query; never on the CPU)."""
        return self.events is not None and not self.events[i].query()

    def stage(self, i: int, cloud: np.ndarray) -> None:
        h = self._host[i]
        n, c = cloud.shape
        h[:n, :c] = cloud
        h[:n, c:] = 0
        if self.rows[i] > n:
            h[n:self.rows[i]] = 0

    def upload(self, i: int, n: int, cap: int) -> torch.Tensor:
        """Slot i's scan of ``n`` rows on the device, as the (cap, 4) points
        of a frame."""
        _copy_rows(self.dev[i], self.host[i], max(n, self.rows[i]), self.pinned)
        self.rows[i] = n
        return self.dev[i, :cap]

    def read(self, i: int, packed: torch.Tensor) -> None:
        """Queue the copy of slot i's packed result to the host, then its
        event."""
        if i == 0 and (self.back is None or self.back.shape[1] != packed.shape[0]):
            self.back = torch.empty((len(self.rows), packed.shape[0]), dtype=torch.uint8,
                                    pin_memory=self.pinned)
            self._back = self.back.numpy()
        self.back[i].copy_(packed, non_blocking=self.pinned)
        if self.events is not None:
            self.events[i].record(torch.cuda.current_stream(self.device))

    def wait(self, i: int) -> np.ndarray:
        """Slot i's packed result on the host, once its copy has ended."""
        if self.events is not None:
            self.events[i].synchronize()
        return self._back[i]

    def drain(self) -> None:
        """Wait for every copy queued (after a call that failed midway)."""
        if self.pinned:
            torch.cuda.current_stream(self.device).synchronize()


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
        self._slots: Optional[_Slots] = None  # the sequence path's buffers
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

    def _readback(self, res: FrameResult, inherited: Optional[torch.Tensor]) -> np.ndarray:
        """The one device -> host copy of a frame's results, as the packed
        host buffer that :func:`_unpack_result` reads."""
        mask = res.ground_mask
        with profiling.span("facade.readback", scans=mask.shape[0] if mask.dim() > 1 else 1):
            return _pack_result(res, inherited=inherited).cpu().numpy()

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
            inherited = cf.inherited_planes
            buf = self._readback(res, inherited)
            self.last_result = res
            with profiling.span("facade.unpack", host_only=True):
                mask, num_ground, means, normals, proc = _unpack_result(buf, res)
                out = _result(mask, means, normals, proc, n)
                if inherited is not None:
                    profiling.count("frame.inherited_planes", _unpack_inherited(buf))
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
        card one captured graph, whatever the run's length) as a pipeline
        (the module's docstring), each scan's result read back packed;
        ``time_taken_s`` holds the run's wall time on its first entry and
        0.0 on the rest."""
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

    def _slots_for(self, b: int, cap: int) -> _Slots:
        if self._slots is None or not self._slots.fits(b, cap):
            old = self._slots
            self._slots = _Slots(max(b, len(old.rows)) if old else b,
                                 max(cap, old.host.shape[1]) if old else cap, self.device)
        return self._slots

    def _run_sequence(self, clouds, cap: int) -> list:
        cf = self._frame(self._rnr(clouds[0]), cap)
        inherited = cf.inherited_planes
        b = len(clouds)
        npts = [c.shape[0] for c in clouds]
        slots = self._slots_for(b, cap)
        stage, upload, launch, readback, unpack = (
            profiling.phase("facade.stage", host_only=True), profiling.phase("facade.upload"),
            profiling.phase("dispatch.launch"), profiling.phase("facade.readback"),
            profiling.phase("facade.unpack", host_only=True))
        step = profiling.span("facade.step", scans=b, timed=True)
        with step:
            out = None
            try:
                for i, (cloud, n) in enumerate(zip(clouds, npts)):
                    with stage:
                        if i and slots.busy(i - 1):
                            profiling.count("facade.overlapped_scans")
                        slots.stage(i, cloud)
                    with upload:
                        x = slots.upload(i, n, cap)
                    with launch:
                        out, res = cf.scan(out, b, i, x, n)
                    with readback:
                        slots.read(i, _pack_result(res, slots.weights, inherited))
            except BaseException:
                slots.drain()
                raise
            self.last_result = FrameResult(*(f[-1] for f in out))
            results = []
            for i, n in enumerate(npts):
                with readback:
                    buf = slots.wait(i)
                with unpack:
                    mask, _, means, normals, proc = _unpack_result(buf, res)
                    results.append(_result(mask, means, normals, proc, n))
                    if inherited is not None:
                        profiling.count("frame.inherited_planes", _unpack_inherited(buf))
            for phase in (stage, upload, launch, readback, unpack):
                phase.done(b)
        results[0] = results[0]._replace(time_taken_s=step.seconds)
        return results

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
