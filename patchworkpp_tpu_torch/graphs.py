"""Captured frames: the port's counterpart of the JAX package's ``jax.jit``
of a frame or a sequence.

The JAX package never runs its frame op by op: every single-device entry
point compiles it (``models/patchworkpp.py:207``, ``pipeline.py:1020-1028``,
``parallel/chunked.py:89`` and ``:218``, ``parallel/sharded.py:85``,
``cli/bench.py``, ``cli/soak.py``, ``cli/stream_bench.py``), and a sequence
is one device program. Run eagerly from Python, the port's fused frame
issues some 1,400 small launches whose host time is most of the frame.
Here the frame of one engine, RNR setting and capacity is captured once as
a CUDA graph (``torch.cuda.graphs``) over static buffers and replayed:

- static inputs: the (capacity, 4) points, ``npts`` as a 0-d int32 tensor
  (the frame clamps it on the device, ``pipeline.make_frame_fn``) and the
  eight :class:`~patchworkpp_tpu_torch.state.AdaptiveState` tensors;
- the graph ends by copying the new state into those state buffers, so the
  state carries itself from replay to replay with no launch from Python;
- static outputs: the six FrameResult fields, overwritten by each replay.
  :meth:`CapturedFrame.__call__` clones them and
  :meth:`CapturedFrame.sequence` copies each frame's into a (B, ...)
  stack, so a result stays valid after the next replay (the JAX results
  this mirrors are immutable).

A frame from Python is then one device-to-device copy of the scan, one
write of ``npts``, one replay and the result copies. A sequence of B frames
replays the one frame graph B times: one graph (and one memory pool) per
capacity, whatever B is.

Before capture the frame runs a few times on a side stream, as
``torch.cuda.graphs`` requires: that builds the kernels with nvcc, sets
their shared-memory attributes at their first call, makes K1's cached
pass-program tensor and has KS's cluster route query its occupancy once,
none of which a capture may do. The kernel wrappers
count a launch at each Python call, so a capture would count once and a
replay never: the capture's count is taken back and each replay adds the
launches it holds.

The host's time issuing a step is the span ``dispatch.launch``
(``utils/profiling.py``: the copy-in, the ``npts`` write, the replays and
the result copies), a capture's the span ``dispatch.capture`` (its eager
warm-up frames and the capture; ``dispatch.captures`` counts the graphs).
On the card each replay is bracketed by two timing events from a pool made
at capture, recorded on the stream around ``graph.replay()``. Each timed
replay first records, as ``frame.span`` records of their device time, the
earlier replays whose end event has completed (a query, which does not
block), so the timing adds no synchronisation and every caller is served
alike; a replay's span is recorded at the next replay after it ended.

Every engine on one card is captured: the fused ones (K1, K2), the
unfused one (its per-patch sums the kernel KR, which reads nothing back to
the host), and the chunked frame of ``parallel/chunked.py``, whose chunk
threads issue their work in turns on the capturing stream, so that the
graph holds every chunk's kernels in that order (KS's cluster route for
up to 8 chunks, its phase route beyond) and a replay runs them with no
thread. Every frame's label replay is one launch of the kernel KL
(``ops/label_replay_kernel.py``). What a frame step cannot be captured for it says in its
``eager_only`` (``pipeline.FrameComm.eager_only``): a comm over a process
group (gloo gathers through the host; an NCCL group spans cards), and the
shard x chunk composition over one. The profiled frame (its per-stage
ranges) also runs eagerly. :meth:`CapturedFrame.capture` raises for them
and for buffers on the CPU, and never falls back. On the CPU the same
static-buffer step runs eagerly, which is how the tests hold its logic to
the eager chain.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict

import torch

from patchworkpp_tpu_torch.ops.fit_kernel import fused_fit
from patchworkpp_tpu_torch.ops.fit_kernel_grid import fused_fit_grid
from patchworkpp_tpu_torch.ops.label_replay_kernel import label_replay
from patchworkpp_tpu_torch.ops.patch_reduce_kernel import (
    patch_moment_sums_kernel,
    patch_reduce_kernel,
)
from patchworkpp_tpu_torch.ops.sharded_fit import sharded_fit
from patchworkpp_tpu_torch.params import Params
from patchworkpp_tpu_torch.pipeline import FrameResult
from patchworkpp_tpu_torch.state import AdaptiveState, init_state
from patchworkpp_tpu_torch.utils import profiling

# Eager frames run before capture (torch.cuda.graphs' side-stream warm-up).
WARMUP_FRAMES = 3
# Pairs of timing events a captured frame keeps for its replays' frame.span
# (a 24-scan sequence holds up to 24 in flight).
TIMING_PAIRS = 64
# The kernel wrappers whose ``launches`` counters a replay advances.
COUNTED = (fused_fit_grid, fused_fit, sharded_fit, patch_reduce_kernel, patch_moment_sums_kernel,
           label_replay)


def _refusal(frame) -> str | None:
    """Why ``frame`` cannot be captured (None if it can): the reason that
    ``pipeline.make_frame_fn`` and ``parallel/chunked.py`` attach to their
    steps as ``eager_only``."""
    return getattr(frame, "eager_only", "not a frame step of pipeline.make_frame_fn "
                   "or parallel/chunked.py")


class CapturedFrame:
    """One frame step ``frame(state, points, npts)`` over static buffers:
    ``points`` ((capacity, 4) f32), ``npts`` (0-d int32) and ``state``,
    which the step updates in place. Captured as a CUDA graph by
    :meth:`capture`; until then (and always on the CPU) each run is the
    eager step on the same buffers.

    ``state`` is the caller's: several captured frames of one facade (RNR
    on and off, other capacities) share its buffers."""

    def __init__(self, frame, capacity: int, state: AdaptiveState) -> None:
        self._frame = frame
        self.state = state
        self.device = state.sensor_height.device
        self.points = torch.zeros((capacity, 4), dtype=torch.float32, device=self.device)
        self.npts = torch.zeros((), dtype=torch.int32, device=self.device)
        self._graph = None
        self._out = None
        self._per_replay = (0,) * len(COUNTED)
        self.pool_bytes = 0  # device memory the capture allocated, at its peak
        self.replays = 0
        # frame.span: the free timing event pairs (made at capture, on the
        # card) and the replays whose pair is not read yet: (start, end,
        # start_ns, request, parent)
        self._timed = False
        self._free = []
        self._pending = collections.deque()

    @property
    def is_captured(self) -> bool:
        return self._graph is not None

    @property
    def inherited_planes(self) -> torch.Tensor | None:
        """The step's count of inherited planes (``pipeline.carry_planes``),
        a 0-d int32 tensor that each run overwrites; None where the step
        builds no carry."""
        return getattr(self._frame, "inherited_planes", None)

    def _step(self) -> FrameResult:
        """The body a replay runs: one frame on the static buffers."""
        new_state, res = self._frame(self.state, self.points, self.npts)
        self.state.copy_(new_state)
        return res

    def capture(self) -> "CapturedFrame":
        """Warm the frame up on a side stream, then capture it. Raises for a
        frame that must run eagerly and for buffers that are not on CUDA;
        the state is left as it was before the warm-up."""
        reason = _refusal(self._frame)
        if reason:
            raise ValueError(f"cannot capture this frame: {reason}")
        if self.device.type != "cuda":
            raise ValueError(
                f"a CUDA graph captures CUDA tensors; this frame's buffers are on "
                f"{self.device}, where it runs eagerly"
            )
        with profiling.span("dispatch.capture"):
            self._capture()
        profiling.count("dispatch.captures")
        return self

    def _capture(self) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            self._free = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(TIMING_PAIRS)]
            self._timed = True
            start = self.state.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FRAMES):
                    self._step()
            torch.cuda.current_stream().wait_stream(side)
            self.state.copy_(start)
            torch.cuda.synchronize()
            before = [f.launches for f in COUNTED]
            torch.cuda.reset_peak_memory_stats(dev)
            allocated = torch.cuda.memory_allocated(dev)
            graph = torch.cuda.CUDAGraph()
            # on this frame's own side stream (torch.cuda.graph's default is
            # one stream for the process); thread_local: another thread's CUDA
            # calls (the server's caller, a second facade) neither break nor
            # join this capture
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out = self._step()
            self.pool_bytes = torch.cuda.max_memory_allocated(dev) - allocated
        self._per_replay = tuple(f.launches - b for f, b in zip(COUNTED, before))
        for f, b in zip(COUNTED, before):  # the capture launched nothing
            f.launches = b
        self._graph, self._out = graph, out

    def run(self, points: torch.Tensor, npts) -> FrameResult:
        """One frame of ``points`` ((capacity, 4), on this frame's device)
        with ``npts`` real rows (an int or a 0-d tensor on the device).
        Returns the static outputs, which the next run overwrites."""
        if tuple(points.shape) != tuple(self.points.shape):
            raise ValueError(f"points have shape {tuple(points.shape)}, this captured "
                             f"frame takes {tuple(self.points.shape)}")
        self.points.copy_(points)
        self.npts.fill_(npts if isinstance(npts, torch.Tensor) else int(npts))
        if self._graph is None:
            return self._step()
        # on the calling thread's current stream of the capture's device
        # (CUDAGraph.replay sets that device), after the two writes above
        if self._timed and profiling.enabled():
            self._timed_replay()
        else:
            self._graph.replay()
        for f, n in zip(COUNTED, self._per_replay):
            f.launches += n
        self.replays += 1
        return self._out

    def _timed_replay(self) -> None:
        """One replay between a pair of timing events on the stream, after
        the ``frame.span`` records of the replays that have ended."""
        self._record_frame_spans()
        if not self._free:  # the oldest replay is not done: its time is lost
            self._free.append(self._pending.popleft()[:2])
        start, end = self._free.pop()
        request, parent = profiling.current()
        stream = torch.cuda.current_stream(self.device)
        start_ns = time.time_ns()
        start.record(stream)
        self._graph.replay()
        end.record(stream)
        self._pending.append((start, end, start_ns, request, parent))

    def _record_frame_spans(self) -> None:
        """Record a ``frame.span`` for each timed replay whose events have
        completed, in order; its start is when the host launched the
        replay, on the host clock."""
        while self._pending and self._pending[0][1].query():
            start, end, start_ns, request, parent = self._pending.popleft()
            profiling.record("frame.span", start_ns, int(start.elapsed_time(end) * 1e6),
                             request=request, parent=parent)
            self._free.append((start, end))

    def __call__(self, points: torch.Tensor, npts) -> FrameResult:
        """One frame; the result is the caller's (a copy of the outputs)."""
        with profiling.span("dispatch.launch"):
            return FrameResult(*(f.clone() for f in self.run(points, npts)))

    def sequence(self, stack: torch.Tensor, npts) -> FrameResult:
        """The frames of a (B, capacity, 4) stack in order, the state
        carried; every FrameResult field stacked on a leading B axis."""
        b = stack.shape[0]
        out = None
        with profiling.span("dispatch.launch", scans=b):
            for i in range(b):
                res = self.run(stack[i], npts[i])
                if out is None:
                    out = FrameResult(*(f.new_empty((b,) + tuple(f.shape)) for f in res))
                for o, f in zip(out, res):
                    o[i].copy_(f)
        return out


class CompiledFrame:
    """``fn(state, points, npts) -> (state, FrameResult)`` with the
    signature of ``pipeline.make_frame_fn``'s step, as ``jax.jit`` of it
    is: a :class:`CapturedFrame` of ``frame`` per capacity, built at first
    use (on the CPU run eagerly). ``state`` is copied into the static
    buffers and the new state comes back as a copy, so callers can hold
    several states (streams) and pass each in turn, from any thread and on
    any CUDA stream: one call at a time holds the static buffers, and on
    the card a call's work waits for the previous call's (an event recorded
    on its stream after the copy-out). Raises at construction for a frame
    that must run eagerly on the card."""

    def __init__(self, frame, params: Params, device="cuda") -> None:
        self._frame = frame
        self._params = params
        self.device = torch.device(device)
        if self.device.type == "cuda" and _refusal(frame):
            raise ValueError(f"cannot capture this frame: {_refusal(frame)}")
        self.frames: Dict[int, CapturedFrame] = {}
        # one caller at a time on the static buffers (jax.jit's function is
        # pure, so callers share it across threads): building a frame, and a
        # call's copy-in, replay and copy-out, hold the lock
        self._lock = threading.RLock()
        self._done = None  # the last call's event on its stream (card only)

    @property
    def is_captured(self) -> bool:
        """Every frame built so far is a CUDA graph (and at least one was built)."""
        return bool(self.frames) and all(cf.is_captured for cf in self.frames.values())

    def captured(self, capacity: int) -> CapturedFrame:
        """The captured frame of this capacity (built, and on the card
        captured, at its first use)."""
        with self._lock:
            cf = self.frames.get(capacity)
            if cf is None:
                cf = CapturedFrame(self._frame, capacity, init_state(self._params, self.device))
                if self.device.type == "cuda":
                    cf.capture()
                self.frames[capacity] = cf
            return cf

    def _locked(self, capacity: int, state: AdaptiveState, run):
        """``run(cf)`` on the captured frame of ``capacity`` with ``state``
        copied in; returns (a copy of the new state, ``run``'s result)."""
        with self._lock:
            cf = self.captured(capacity)
            if self._done is not None:
                torch.cuda.current_stream(self.device).wait_event(self._done)
            cf.state.copy_(state)
            res = run(cf)
            new = cf.state.clone()
            if self.device.type == "cuda":
                self._done = torch.cuda.Event()
                self._done.record(torch.cuda.current_stream(self.device))
            return new, res

    def __call__(self, state: AdaptiveState, points: torch.Tensor, npts):
        return self._locked(points.shape[0], state, lambda cf: cf(points, npts))


class CompiledSequence(CompiledFrame):
    """``fn(state, stack, npts) -> (state, FrameResult)`` over a (B, P, 4)
    stack, the signature of ``pipeline.make_sequence_fn``: the captured
    frame of capacity P replayed B times (one graph whatever B is)."""

    def __call__(self, state: AdaptiveState, stack: torch.Tensor, npts):
        return self._locked(stack.shape[1], state, lambda cf: cf.sequence(stack, npts))
