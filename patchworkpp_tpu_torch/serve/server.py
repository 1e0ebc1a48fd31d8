"""Streaming ground-segmentation server (port of
``patchworkpp_tpu/serve/server.py``), the ROS 2 node's transport-agnostic
equivalent.

The reference wraps the core in an rclcpp component that subscribes to a
PointCloud2 topic and republishes input/ground/nonground clouds (reference:
ros/src/GroundSegmentationServer.cpp:53-95). This server reproduces that
capability:

- a subscriber callback interface (``on_result``) taking the role of the
  three publishers;
- a bounded input queue + worker thread taking the role of the rclcpp
  executor delivering messages;
- one fixed capacity: each message is uploaded as its 8192-row bucket and
  zero-extended on the device, the adaptive state stays on the device;
- like the reference server, RNR is disabled unless the feed provides
  intensity (GroundSegmentationServer.cpp:47 forces enable_RNR=false because
  PointCloud2 intensity isn't wired through).

The engine is the port's :class:`PatchworkPP` on ``device`` ("cuda" unless
the caller asks for "cpu"); without CUDA the constructor raises. The worker
thread launches on that device (``torch.cuda.current_stream`` is per
thread). The fit kernel is built at its first launch, so on a fresh process
the worker's first frame builds it.

Three behaviours differ from the JAX package's server on purpose (its
faults, VERDICT.md "What's weak" #1, #2 and #5):

- a scan that raises in the worker is answered, not fatal: its
  ``ResultMsg`` carries ``result=None`` and the exception in ``error``, and
  the worker goes on serving (``worker_error`` keeps the last one). The JAX
  server's worker ends on it and leaves later messages unanswered;
- a ``ServerConfig`` whose ``batch_max`` the queue cannot fill
  (``batch_max > queue_depth``: a busy worker comes back to at most
  ``queue_depth`` waiting messages) raises ``ValueError``. The JAX server
  accepts it and never batches;
- ``latency_s`` is each message's own time from ``publish()`` to its answer,
  its wait in the queue included. The JAX server gives every message of a
  batch the batch's inference time.

A ROS 2 bridge, when rclpy is available, is a thin adapter over this class
(see serve/ros2_bridge.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from patchworkpp_tpu_torch.models import PatchworkPP, SegmentationResult
from patchworkpp_tpu_torch.params import Params
from patchworkpp_tpu_torch.utils.profiling import FrameTimer


class CloudMsg(NamedTuple):
    """An input message: one scan + metadata (the PointCloud2 analog)."""

    points: np.ndarray          # (N, 3) or (N, 4) float32
    stamp: float                # seconds
    frame_id: str = "base_link"


@dataclasses.dataclass
class ResultMsg:
    """Published result (the three-publisher analog, indices not copies)."""

    msg: CloudMsg
    result: Optional[SegmentationResult]  # None when the scan raised
    latency_s: float                      # publish() to this answer
    error: Optional[BaseException] = None


@dataclasses.dataclass
class ServerConfig:
    capacity: int = 131072       # fixed padded capacity (points per scan)
    queue_depth: int = 4         # bounded input queue (drops oldest when full)
    drop_when_full: bool = True  # real-time mode: prefer freshness to backlog
    # Throughput mode: when a backlog of >= batch_max scans is queued, run
    # them as ONE sequence call (model.estimate_ground_sequence: equal to
    # the per-frame loop, one readback for the batch). Only the exact size
    # batch_max is ever batched. 1 disables batching (live/low-latency mode).
    batch_max: int = 1
    # The JAX package's chunked single-device frame; not ported yet (ROADMAP
    # queue 1, item 13, multi-device), so any value but 1 makes the engine
    # raise.
    chunks: int = 1

    def __post_init__(self) -> None:
        # A busy worker comes back to at most queue_depth waiting messages
        # (drop-oldest keeps the queue at its depth), so a larger batch
        # would assemble only if a publish landed between its dequeues.
        # (queue_depth <= 0 is queue.Queue's unbounded queue.)
        if 0 < self.queue_depth < self.batch_max:
            raise ValueError(
                f"batch_max {self.batch_max} > queue_depth {self.queue_depth}: "
                "a backlog that size never waits in the queue, so it never batches"
            )


class GroundSegmentationServer:
    """Callback-driven streaming server around the stateful engine."""

    def __init__(
        self,
        params: Optional[Params] = None,
        config: Optional[ServerConfig] = None,
        device: Optional[str] = None,
    ) -> None:
        self.params = params or Params()
        self.config = config or ServerConfig()
        self._model = PatchworkPP(
            self.params,
            capacity=self.config.capacity,
            device=device,
            chunks=self.config.chunks,
        )
        self.device = self._model.device
        self._subs: List[Callable[[ResultMsg], None]] = []
        # (publish time, message); None stops the worker
        self._queue: "queue.Queue[Optional[Tuple[float, CloudMsg]]]" = queue.Queue(
            maxsize=self.config.queue_depth
        )
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self.frames_processed = 0
        self.frames_dropped = 0
        self.worker_error: Optional[BaseException] = None
        # Cumulative host-side timing (the reference's time_taken_ /
        # verbose-split analog for the serving loop): wait = queue idle,
        # infer = engine time. timing_report() renders per-frame numbers.
        self.timer = FrameTimer()

    # ------------------------------------------------------------------ pub/sub

    def on_result(self, callback: Callable[[ResultMsg], None]) -> None:
        """Subscribe to segmentation results (ground/nonground publishers)."""
        self._subs.append(callback)

    def publish(self, msg: CloudMsg) -> None:
        """Enqueue a scan (the pointcloud_topic subscription)."""
        if not self._running:
            raise RuntimeError("server not started")
        item = (time.perf_counter(), msg)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            if not self.config.drop_when_full:
                self._queue.put(item)
                return
            try:  # drop oldest, keep newest — real-time semantics
                self._queue.get_nowait()
                self.frames_dropped += 1
            except queue.Empty:
                pass
            self._queue.put_nowait(item)

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self, timeout: float = 10.0) -> None:
        if not self._running:
            return
        self._running = False
        self._queue.put(None)
        assert self._worker is not None
        self._worker.join(timeout)
        self._worker = None

    @property
    def worker_alive(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def __enter__(self) -> "GroundSegmentationServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ worker

    def _run(self) -> None:
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        try:
            with on_card:
                self._serve()
        except BaseException as e:  # a fault outside a scan: the worker ends
            self.worker_error = e
            raise

    def _serve(self) -> None:
        stopped = False
        while not stopped:
            with self.timer.segment("wait"):
                item = self._queue.get()
            if item is None or not self._running:
                break
            batch = [item]
            # Backlog batching: drain up to batch_max pending scans and run
            # them as one sequence call, at the exact size batch_max only.
            while len(batch) < self.config.batch_max:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stopped = True
                    break
                batch.append(nxt)
            with self.timer.segment("infer"):
                answers = self._infer([m for _, m in batch])
            self.frames_processed += len(batch)
            for _ in batch:
                self.timer.tick_frame()
            for (t_pub, m), (r, err) in zip(batch, answers):
                out = ResultMsg(msg=m, result=r, latency_s=time.perf_counter() - t_pub,
                                error=err)
                for cb in self._subs:
                    cb(out)
            if not self._running:
                break

    def _infer(self, msgs: List[CloudMsg]):
        """(result, error) for each message, in order. An exception is kept
        as that message's error; a batch whose sequence call raises runs
        again message by message from the state it started with (the frame
        step returns a new state, so restoring the old one undoes a run
        that a mixed 3/4-column batch committed before the failure)."""
        if len(msgs) == self.config.batch_max and len(msgs) > 1:
            start = self._model.state
            try:
                return [(r, None) for r in self._model.estimate_ground_sequence(
                    [m.points for m in msgs])]
            except Exception:
                self._model.state = start
        out = []
        for m in msgs:
            try:
                out.append((self._model.estimate_ground(m.points), None))
            except Exception as e:  # answered with the error; keep serving
                self.worker_error = e
                out.append((None, e))
        return out

    # ------------------------------------------------------------------ sync API

    def process(self, msg: CloudMsg) -> ResultMsg:
        """Synchronous one-shot (bypasses the queue; for tests/batch use)."""
        t0 = time.perf_counter()
        result = self._model.estimate_ground(msg.points)
        return ResultMsg(msg=msg, result=result, latency_s=time.perf_counter() - t0)

    def timing_report(self) -> str:
        """Per-frame wait/infer split of the serving loop (the reference's
        verbose getTimeTaken analog; utils.profiling.FrameTimer)."""
        return self.timer.report()

    # ------------------------------------------------------------ persistence

    def save_state(self, path: str) -> None:
        """Checkpoint the adaptive state (thresholds, sensor height, FIFO
        buffers) so a restarted server resumes adaptation exactly where this
        one stopped (the reference's state dies with the process,
        patchworkpp.h:174-175). The npz keys are the JAX package's, so either
        package's server can resume the other's checkpoint. Call while
        stopped or between frames; the worker thread is not paused here."""
        self._model.save_state(path)

    def load_state(self, path: str) -> None:
        """Restore a checkpoint saved by :meth:`save_state`."""
        self._model.load_state(path)

    @property
    def sensor_height(self) -> float:
        return self._model.sensor_height
