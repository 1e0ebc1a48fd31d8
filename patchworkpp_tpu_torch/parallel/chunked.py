"""Single-device CHUNKED frame (port of ``patchworkpp_tpu/parallel/chunked.py``):
the point-sharded per-shard program over K row blocks of one device.

The K chunks are K shards whose transport lives in the process: one thread
per chunk runs the same per-shard frame (``pipeline.make_frame_fn`` with a
``MeshComm``), and at each hook every thread deposits its tensor in its
slot and reads the same stack; the threads take turns, one running at a
time (:class:`Exchange`). The
point-sharded path runs the same frame and the same ``MeshComm`` arithmetic
over process ranks, so chunked K equals point-sharded K bit for bit by
construction. (The JAX package makes the chunk axis a vmapped leading
dimension instead; here that would be a batched rewrite of the binning,
the sort, the tiled layout and the replay.)

On CUDA every chunk thread launches on the caller's device and current
stream (``torch.cuda.current_stream`` is per thread, so the caller's is
passed in): the chunks' kernels queue on one stream, in the order the
threads issue them, and each hook's stack follows the tensors it reads.
Without an outer group every exchange is such a device op, so the whole
chunked frame can be captured as one CUDA graph (``graphs.py``): the
capture is taken on the caller's side stream, where the threads issue
their work in turn order, and a replay runs every chunk's kernels with no
thread at all. On the card :func:`make_chunked_frame_fn` and
:func:`make_chunked_sequence_fn` return that compiled form, as the JAX
package returns ``jax.jit`` of its vmapped frame; the shard x chunk
composition gathers across processes and stays eager.

Like the JAX package's, this is a correctness and emulation feature and the
building block of the shard x chunk composition, not a speed lever: under
the sharded comm the fit is the sharded fit kernel KS on the card
(``ops/sharded_fit.py``) and its plain version, the composed
``ops/tiled_fit.py``, on the CPU; never K1. Without an outer group (up to 8
chunks) KS takes its cluster route: the chunks meet once a frame in the fit
(:meth:`ChunkComm.meet_local`, their fit inputs handed to the last chunk,
which launches one cluster kernel for all); with one (shard x chunk) each chunk
launches KS's phases with the comm's exchanges between them, about a dozen
meetings a frame. ``num_chunks=1`` is the plain frame, K1 and all.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from patchworkpp_tpu_torch.device import resolve_device
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.parallel.point_sharded import (
    GroupTransport,
    MeshComm,
    build,
    rank_rows,
)
from patchworkpp_tpu_torch.pipeline import make_frame_fn, sequence_of
from patchworkpp_tpu_torch.state import init_state


class Exchange:
    """The chunk threads' meeting point, where they take turns.

    One chunk thread runs at a time, in chunk order, and hands the turn on
    at each hook: ``gather(i, x)`` deposits chunk ``i``'s tensor and passes
    the turn to chunk ``i + 1``; the last chunk stacks the deposits (and, in
    the shard x chunk composition, gathers the stack across the ranks of
    ``outer``, rank-major) before it passes the turn back to chunk 0. A
    chunk reads the stack when its turn comes again, before the next stack
    is made. (Free-running threads, meeting at a barrier, spent most of
    their time handing the interpreter lock back and forth between PyTorch
    calls, and took several times the work they did.)"""

    def __init__(self, n: int, outer: GroupTransport | None = None) -> None:
        self.n = n
        self.outer = outer
        self.slots = [None] * n
        self.result = None
        self.cond = threading.Condition()
        self.turn = 0
        self.broken = False

    def reset(self) -> None:
        self.turn, self.broken = 0, False

    def wait_turn(self, i: int) -> None:
        with self.cond:
            self.cond.wait_for(lambda: self.turn == i or self.broken)
            if self.broken:
                raise threading.BrokenBarrierError(f"chunk {i}: another chunk failed")

    def pass_turn(self, i: int) -> None:
        with self.cond:
            self.turn = (i + 1) % self.n
            self.cond.notify_all()

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()

    def gather(self, i: int, x: torch.Tensor) -> torch.Tensor:
        def stack(slots):
            g = torch.stack(slots)
            if self.outer is not None:
                g = self.outer.gather(g).reshape(-1, *x.shape)
            return g

        return self.meet(i, x, stack)

    def meet(self, i: int, x, fn):
        """Chunk ``i`` deposits ``x`` (any object) and passes the turn on;
        the last chunk calls ``fn`` on the deposits in chunk order. Every
        chunk returns what ``fn`` returned (a chunk raising in ``fn`` ends
        the others through :meth:`abort`, as any chunk's error does)."""
        self.slots[i] = x
        if i == self.n - 1:
            self.result = fn(list(self.slots))
        self.pass_turn(i)
        self.wait_turn(i)
        return self.result


class ChunkTransport:
    """Chunk ``chunk`` of an :class:`Exchange`; with an outer group its
    linear index is ``rank * K + chunk`` (shard-major, chunk-minor)."""

    def __init__(self, exchange: Exchange, chunk: int) -> None:
        self.exchange = exchange
        self.chunk = chunk
        self.index = chunk + (exchange.outer.index * exchange.n if exchange.outer else 0)

    @property
    def eager_only(self) -> str | None:
        """None without an outer group (the chunks' stacks are device ops on
        the caller's stream), else why the composition runs eagerly."""
        if self.exchange.outer is None:
            return None
        return ("shard x chunk: the outer process group's gathers cross processes, so "
                "the composition runs eagerly")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.exchange.gather(self.chunk, x)


class ChunkComm(MeshComm):
    """A chunk's :class:`MeshComm`, whose chunks can also meet as threads of
    this process: :meth:`meet_local` is the sharded fit's cluster route
    (``ops/sharded_fit.py``), all the chunks' fits in one launch."""

    def meet_local(self, x, fn, most: int):
        """``fn([x of chunk 0, ..., x of chunk K-1])[chunk]``, ``fn`` called
        once by the last chunk in its turn, where the exchange has no outer
        group and K <= ``most``; else None, with no meeting (every chunk
        decides alike)."""
        t = self.transport
        ex = t.exchange
        if ex.outer is not None or ex.n > most:
            return None
        return ex.meet(t.chunk, x, fn)[t.chunk]


def run_chunks(exchange: Exchange, tasks, stream=None) -> list:
    """Run ``tasks[i]()`` (chunk ``i``'s work, whose hooks meet at
    ``exchange``) in one thread per chunk, in turns, on ``stream`` where
    given. Returns the results in chunk order; raises the first error (a
    chunk that fails wakes the others, which fail with BrokenBarrierError)."""
    exchange.reset()

    def run(i):
        try:
            exchange.wait_turn(i)
            with torch.cuda.stream(stream) if stream else contextlib.nullcontext():
                out = tasks[i]()
            exchange.pass_turn(i)
            return out
        except BaseException:
            exchange.abort()
            raise

    with ThreadPoolExecutor(len(tasks), thread_name_prefix="ppk-chunk") as pool:
        futures = [pool.submit(run, i) for i in range(len(tasks))]
    errors = [f.exception() for f in futures]
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return [f.result() for f in futures]


def _chunk_wiring(params, geom, device, fused, num_chunks, outer=None):
    """The :class:`Exchange` of ``num_chunks`` chunks, each chunk's comm,
    and each chunk's per-shard frame on that comm."""
    exchange = Exchange(num_chunks, outer)
    comms = [ChunkComm(ChunkTransport(exchange, i)) for i in range(num_chunks)]
    frames = [make_frame_fn(params, geom, device, fused, comm=c) for c in comms]
    return exchange, comms, frames


def _chunk_frames(params, geom, device, fused, num_chunks, outer=None):
    """``fn(state, rows, npts) -> (state, FrameResult)`` running ``rows`` as
    ``num_chunks`` contiguous blocks in as many threads, one per-shard frame
    each; the result's mask is the chunks' masks in row order, every other
    field chunk 0's (the same in every chunk)."""
    exchange, _, frames = _chunk_wiring(params, geom, device, fused, num_chunks, outer)

    def fn(state, rows: torch.Tensor, npts):
        r = rows.shape[0] // num_chunks
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        outs = run_chunks(exchange, [
            functools.partial(frames[i], state, rows[i * r:(i + 1) * r], npts)
            for i in range(num_chunks)
        ], stream)
        return outs[0][0], outs[0][1]._replace(
            ground_mask=torch.cat([res.ground_mask for _, res in outs]))

    # every chunk's frame is on the same kind of comm
    fn.eager_only = frames[0].eager_only
    return fn


def _chunk_fit_tables(params: Params, num_chunks: int, points: torch.Tensor, npts: int,
                      fits, device="cuda") -> list:
    """For checks only (tests and chip_smoke.py), not a frame path: the
    chunked frame's fit stage alone, to hold one sharded fit against
    another. ``points`` (P, 4) is cut into ``num_chunks`` row blocks, each
    binned and tiled by its chunk's frame (fresh state); then each of
    ``fits`` (``fit(fit_inputs, comm) -> table``) runs on every chunk in
    turn, meeting the other chunks through the chunk comm. Returns, chunk
    by chunk, the list of each fit's table."""
    dev = resolve_device(device)
    _check_rows(points.shape[0], num_chunks, "point capacity")
    exchange, comms, frames = _chunk_wiring(params, CZMGeometry.create(params), dev, None,
                                            num_chunks)
    state = init_state(params, dev)
    r = points.shape[0] // num_chunks

    def task(i):
        fi = frames[i].fit_inputs(state, points[i * r:(i + 1) * r], npts)
        return [fit(fi, comms[i]) for fit in fits]

    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    return run_chunks(exchange, [functools.partial(task, i) for i in range(num_chunks)],
                      stream)


def _check_rows(rows: int, num_chunks: int, what: str) -> None:
    if rows % num_chunks:
        raise ValueError(f"{what} {rows} not divisible by num_chunks={num_chunks}")


def chunked_step(params: Params, num_chunks: int, geom: CZMGeometry, fused,
                 device: torch.device):
    """The chunked frame step itself, ``fn(state, points, npts) -> (state,
    FrameResult)``, run eagerly wherever it is called: what
    :func:`make_chunked_frame_fn` compiles, and what the facade captures
    over its own state buffers (``models/patchworkpp.py``). ``npts`` is an
    int or a 0-d tensor on ``device``; ``num_chunks=1`` is the plain frame."""
    if num_chunks == 1:
        return make_frame_fn(params, geom, device, fused)
    run = _chunk_frames(params, geom, device, fused, num_chunks)

    def fn(state, points: torch.Tensor, npts):
        _check_rows(points.shape[0], num_chunks, "point capacity")
        return run(state, points, npts)

    fn.eager_only = run.eager_only
    return fn


def make_chunked_frame_fn(
    params: Params,
    num_chunks: int,
    geom: CZMGeometry | None = None,
    fused=None,
    device="cuda",
):
    """``fn(state, points, npts) -> (state, FrameResult)`` processing the
    (P, 4) points as ``num_chunks`` contiguous row blocks on one device (P
    divisible by ``num_chunks``).

    The semantics are the point-sharded path's (the same ``MeshComm``
    hooks and fixed-order reductions), so the result equals
    ``point_sharded.build`` over a group of ``num_chunks`` ranks.
    ``fused`` is None/"tiled" (the default, the sharded fit program: KS
    on the card) or False (the unfused engine); ``num_chunks=1`` is the
    plain frame with this engine selection.

    On the card this is a ``graphs.CompiledFrame`` (the step captured as a
    CUDA graph per capacity, replayed a call; raises where it cannot be
    captured), as the JAX package jits it; on the CPU the step itself."""
    dev = resolve_device(device)
    step = chunked_step(params, num_chunks, geom or CZMGeometry.create(params), fused, dev)
    if dev.type != "cuda":
        return step
    from patchworkpp_tpu_torch.graphs import CompiledFrame

    return CompiledFrame(step, params, dev)


def make_chunked_sequence_fn(
    params: Params,
    num_chunks: int,
    geom: CZMGeometry | None = None,
    fused=None,
    device="cuda",
):
    """Chunked analog of ``pipeline.make_sequence_fn``: ``fn(state, stack,
    npts) -> (state, FrameResult)`` over a (B, P, 4) stack, the chunked
    frame in order with the state threaded through, every field stacked on
    a leading B axis (equal to the frame loop, bit for bit). On the card a
    ``graphs.CompiledSequence`` (the frame graph replayed once a scan), on
    the CPU the loop of eager steps."""
    dev = resolve_device(device)
    step = chunked_step(params, num_chunks, geom or CZMGeometry.create(params), fused, dev)
    if dev.type != "cuda":
        return sequence_of(step)
    from patchworkpp_tpu_torch.graphs import CompiledSequence

    return CompiledSequence(step, params, dev)


def make_sharded_chunked_frame_fn(
    params: Params,
    num_chunks: int,
    group=None,
    geom: CZMGeometry | None = None,
    fused=None,
    device="cuda",
):
    """Shard x chunk composition: the frame's rows split over the ranks of
    ``group`` (default WORLD), each rank's rows further processed as
    ``num_chunks`` chunks. The global row blocks are rank-major,
    chunk-minor, and the reductions run over (rank, chunk) in that linear
    order, so this is the program of a flat group of ``world * num_chunks``
    shards, bit for bit.

    Every rank calls ``fn(state, points, npts)`` with the whole (P, 4)
    cloud (P divisible by ``world * num_chunks``) and the global count; the
    mask is gathered, so each rank returns the whole result.
    ``num_chunks=1`` is :func:`point_sharded.build`."""
    dev = resolve_device(device)
    geom = geom or CZMGeometry.create(params)
    if num_chunks == 1:
        return build(params, group, fused, geom, dev)
    outer = GroupTransport(group)
    run = _chunk_frames(params, geom, dev, fused, num_chunks, outer)

    def fn(state, points: torch.Tensor, npts: int):
        rows = rank_rows(points, outer, "point capacity")
        _check_rows(rows.shape[0], num_chunks, "per-shard rows")
        state, res = run(state, rows, npts)
        return state, res._replace(ground_mask=outer.gather_rows(res.ground_mask))

    fn.eager_only = run.eager_only
    return fn

