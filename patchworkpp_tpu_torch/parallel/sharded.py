"""Multi-device execution of the frame pipeline (port of
``patchworkpp_tpu/parallel/sharded.py``), over ``torch.distributed``.

Two axes of scale:

1. **Frame data parallelism** (:func:`make_batch_frame_fn`): a batch of
   independent streams split over the ranks of a process group. Each stream
   carries its own :class:`AdaptiveState` and no statistic crosses ranks:
   the adaptive state is per stream, as the reference adapts one sensor's
   thresholds over its own frames.
2. **Point sharding within a frame** (:func:`make_point_sharded_frame_fn`):
   the points of one dense scan split over the ranks, the per-patch
   statistics combined by fixed-order gathers
   (``parallel/point_sharded.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from patchworkpp_tpu_torch.device import resolve_device
from patchworkpp_tpu_torch.params import Params
from patchworkpp_tpu_torch.parallel.point_sharded import (
    GroupTransport,
    build,
    build_sequence,
    rank_rows,
)
from patchworkpp_tpu_torch.pipeline import FrameResult, make_frame_fn
from patchworkpp_tpu_torch.state import AdaptiveState, init_state


def batch_init_state(params: Params, batch: int, device="cuda") -> AdaptiveState:
    """A batch of fresh per-stream states (leading axis = stream)."""
    one = init_state(params, resolve_device(device))
    return AdaptiveState(**{
        f.name: torch.stack([getattr(one, f.name)] * batch)
        for f in dataclasses.fields(one)
    })


def stream_state(states: AdaptiveState, i: int) -> AdaptiveState:
    """Stream ``i``'s state out of a batch of states."""
    return AdaptiveState(**{f.name: getattr(states, f.name)[i]
                            for f in dataclasses.fields(states)})


def make_batch_frame_fn(params: Params, group=None, device="cuda"):
    """Data-parallel batched frame step over the ranks of ``group``
    (default WORLD): ``fn(states, points, npts) -> (states, results)``.

    Every rank calls it with the whole batch: ``points`` (B, P, 4),
    ``npts`` (B,) (ints, or a tensor whose entries stay tensors) and states
    whose every field has a leading B axis, B divisible by the group size.
    Each rank runs its contiguous block of the streams through the plain
    frame (K1 on the card), one stream after another, each with its own
    state: one ``graphs.CompiledFrame`` (on the card the frame captured as
    a CUDA graph and replayed a stream, each stream's state copied in and
    out; on the CPU the same step eagerly), as the JAX package jits its
    per-device body. The new states and the results are then gathered
    across the ranks, outside the graph, so every rank returns all B
    streams' (leading axis B on every field)."""
    from patchworkpp_tpu_torch.graphs import CompiledFrame

    dev = resolve_device(device)
    frame = CompiledFrame(make_frame_fn(params, device=dev), params, dev)
    transport = GroupTransport(group)

    def fn(states: AdaptiveState, points: torch.Tensor, npts):
        new_states, results = [], []
        for b in rank_rows(torch.arange(points.shape[0]), transport, "batch").tolist():
            st, res = frame(stream_state(states, b), points[b], npts[b])
            new_states.append(st)
            results.append(res)
        out_states = AdaptiveState(**{
            f.name: transport.gather_rows(torch.stack([getattr(s, f.name) for s in new_states]))
            for f in dataclasses.fields(AdaptiveState)
        })
        out = FrameResult(*(transport.gather_rows(torch.stack(list(f))) for f in zip(*results)))
        return out_states, out

    fn.compiled = frame  # the rank's compiled frame (is_captured on the card)
    return fn


def make_point_sharded_frame_fn(params: Params, group=None, fused="tiled", device="cuda"):
    """Single-frame step with the points split over the ranks of ``group``;
    see :func:`patchworkpp_tpu_torch.parallel.point_sharded.build`."""
    return build(params, group, fused, device=device)


def make_point_sharded_sequence_fn(params: Params, group=None, fused="tiled",
                                   device="cuda"):
    """Point-sharded sequential chain (the multi-device analog of
    ``pipeline.make_sequence_fn``); see
    :func:`patchworkpp_tpu_torch.parallel.point_sharded.build_sequence`."""
    return build_sequence(params, group, fused, device=device)
