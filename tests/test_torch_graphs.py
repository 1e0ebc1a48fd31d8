"""The captured frame (patchworkpp_tpu_torch/graphs.py) on the CPU, where
no CUDA graph exists: its logic, held to the eager frame and to the JAX
package on seeded synthetic clouds (tests/test_fuzz_parity.py:synth_cloud)
at capacity 8192.

- ``npts`` as a 0-d tensor (a captured frame's static input, clamped on the
  device) gives the bits of the Python int through ``make_frame_fn``, for
  the tiled, onehot and unfused engines, at 0, the cloud's count and the
  capacity, fresh and chained; both equal the JAX frame (labels; state to
  tests/test_torch_frame.py's and test_torch_engines.py's tolerances).
- The static-buffer step equals the eager chain bit for bit over 6 chained
  frames, every FrameResult field and every state field, run eagerly and
  under ``_ReplayOnCpu``, which stands in for a graph: each replay
  overwrites the outputs the capture returned, so a result that aliased
  them would change when the next frame runs.
- Sequences of 1, 3 and 6 frames, ``make_sequence_fn``'s compiled sequence
  and the facade's mixed-RNR batches equal the eager frame loop bit for bit.
- The facade keeps one frame per (RNR, capacity), all on its state buffers,
  which reset, load_state and assignment overwrite in place; its
  last_result survives the next frame.
- Every engine's frame can be captured, the unfused one (its per-patch
  sums the kernel KR on the card) and the chunked frame (its exchanges
  device ops on one card) too: their ``eager_only`` is None, and they fail
  to capture on the CPU only for their buffers. Capture refuses a sharded
  comm, a frame over a process group (a one-rank gloo group here), the
  shard x chunk composition over one, and buffers on the CPU; it never
  runs eagerly in their place. The unfused engine's static-buffer step
  equals its eager chain as the fused engines' does.
- ``pipeline.segment`` equals the JAX package's ``segment``, and two
  threads calling it at once get what the same calls made one after
  another get.
- The frame report counts the host's launch calls (a replay's one graph
  launch, not the graph's kernels) apart from the card's launches.

Every comparison between port paths is bit for bit (tolerance 0): they run
the same operations on the same inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.pipeline as jpipe
import patchworkpp_tpu.state as jstate
import patchworkpp_tpu_torch.pipeline as tpipe
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
from patchworkpp_tpu_torch.graphs import CapturedFrame, CompiledFrame, CompiledSequence
from patchworkpp_tpu_torch.pipeline import FrameComm, FrameResult
from patchworkpp_tpu_torch.state import AdaptiveState
from test_fuzz_parity import CAP, synth_cloud
from test_torch_engines import ENGINE_STATE_ATOL
from test_torch_frame import STATE_ATOL, _assert_state_close, _one_torch_thread, _padded  # noqa: F401


def _clouds(seed, n):
    return [synth_cloud(seed + 5 * k, exact_edges=False) for k in range(n)]


def _assert_results_equal(a: FrameResult, b: FrameResult, label):
    """Every field bit for bit (floats through their int32 bits: a one-point
    patch's NaN eigenvalue equals a NaN with the same bits)."""
    for name in FrameResult._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (label, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), (label, name)


def _assert_states_equal(a: AdaptiveState, b: AdaptiveState, label):
    for k, v in a.to_numpy().items():
        np.testing.assert_array_equal(b.to_numpy()[k], v, err_msg=f"{label} {k}")


class _ReplayOnCpu:
    """A CUDA graph's contract on the CPU: the capture runs the step once and
    keeps its outputs; each replay runs the step again and writes into those
    same output tensors."""

    def __init__(self, cf: CapturedFrame):
        self.cf = cf
        self.out = cf._step()

    def replay(self):
        for o, r in zip(self.out, self.cf._step()):
            o.copy_(r)


def _install_replay(cf: CapturedFrame) -> CapturedFrame:
    start = cf.state.clone()
    cf._graph = _ReplayOnCpu(cf)
    cf._out = cf._graph.out
    cf.state.copy_(start)  # the capture leaves the state as it found it
    return cf


@pytest.fixture(scope="module")
def jax_frames():
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = jax.jit(jpipe.make_frame_fn(JParams(), fused=mode, interpret=True))
        return cache[mode]

    return get


@pytest.mark.parametrize("count", ["zero", "cloud", "capacity"])
@pytest.mark.parametrize("mode", ["tiled", "onehot", False])
def test_npts_tensor_equals_int_and_jax(jax_frames, mode, count):
    """Two chained frames; tolerance: labels and state of the int and tensor
    runs bit for bit, the JAX frame's labels equal, its state floats within
    the engines' tolerances."""
    p = Params()
    frame = tpipe.make_frame_fn(p, device="cpu", fused=mode)
    jf = jax_frames(mode)
    st_i = st_t = init_state(p, device="cpu")
    js = jstate.init_state(JParams())
    for k, cloud in enumerate(_clouds(3, 2)):
        n = {"zero": 0, "cloud": len(cloud), "capacity": CAP}[count]
        pts = _padded(cloud)
        x = torch.from_numpy(pts)
        st_i, r_i = frame(st_i, x, n)
        st_t, r_t = frame(st_t, x, torch.tensor(n, dtype=torch.int32))
        label = f"{mode} npts={count} frame {k}"
        _assert_results_equal(r_i, r_t, label)
        _assert_states_equal(st_i, st_t, label)
        js, jr = jf(js, jnp.asarray(pts), jnp.int32(n))
        np.testing.assert_array_equal(r_t.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=label)
        _assert_state_close(js, st_t, label,
                            atol=STATE_ATOL if mode == "tiled" else ENGINE_STATE_ATOL)
        if count == "zero":
            assert int(r_t.num_ground) == 0
        else:
            assert int(r_t.num_ground) > 0


def test_npts_tensor_is_clamped_to_the_rows():
    """A count past the capacity or below 0 clamps as the int path does."""
    p = Params()
    frame = tpipe.make_frame_fn(p, device="cpu")
    x = torch.from_numpy(_padded(synth_cloud(1, exact_edges=False)))
    for n in (-5, CAP + 100):
        _, r_i = frame(init_state(p, device="cpu"), x, n)
        _, r_t = frame(init_state(p, device="cpu"), x, torch.tensor(n, dtype=torch.int32))
        _assert_results_equal(r_i, r_t, f"npts {n}")


@pytest.mark.parametrize("replayed", [False, True], ids=["eager", "replayed"])
@pytest.mark.parametrize("mode", ["tiled", "onehot", False])
def test_static_step_equals_eager_chain(mode, replayed):
    """Six chained frames through the static buffers == the eager chain,
    every field, bit for bit; frame i's result unchanged after frame i+1."""
    p = Params()
    frame = tpipe.make_frame_fn(p, device="cpu", fused=mode)
    cf = CapturedFrame(frame, CAP, init_state(p, device="cpu"))
    if replayed:
        _install_replay(cf)
    st = init_state(p, device="cpu")
    held = []
    for k, cloud in enumerate(_clouds(11, 6)):
        x = torch.from_numpy(_padded(cloud))
        st, want = frame(st, x, len(cloud))
        got = cf(x, len(cloud))
        _assert_results_equal(got, want, f"frame {k}")
        _assert_states_equal(st, cf.state, f"frame {k}")
        held.append((got, want))
    for k, (got, want) in enumerate(held):
        _assert_results_equal(got, want, f"frame {k} after the chain")
    assert cf.is_captured == replayed and cf.replays == (6 if replayed else 0)


@pytest.mark.parametrize("b", [1, 3, 6])
def test_sequence_equals_frame_loop(b):
    """B frames through CapturedFrame.sequence (replayed) and through
    make_sequence_fn's compiled sequence == the eager frame loop."""
    p = Params()
    clouds = _clouds(21, b)
    stack = torch.from_numpy(np.stack([_padded(c) for c in clouds]))
    npts = [len(c) for c in clouds]
    frame = tpipe.make_frame_fn(p, device="cpu")
    st = init_state(p, device="cpu")
    want = []
    for i in range(b):
        st, r = frame(st, stack[i], npts[i])
        want.append(r)

    cf = _install_replay(CapturedFrame(frame, CAP, init_state(p, device="cpu")))
    got = cf.sequence(stack, npts)
    seq = tpipe.make_sequence_fn(p, device="cpu")
    assert isinstance(seq, CompiledSequence)
    st_seq, got_seq = seq(init_state(p, device="cpu"), stack, torch.tensor(npts))
    for i in range(b):
        _assert_results_equal(FrameResult(*(f[i] for f in got)), want[i], f"replayed {i}")
        _assert_results_equal(FrameResult(*(f[i] for f in got_seq)), want[i], f"compiled {i}")
    _assert_states_equal(st, cf.state, "replayed sequence")
    _assert_states_equal(st, st_seq, "compiled sequence")
    assert cf.replays == b and list(seq.frames) == [CAP]


def test_eager_engines_make_eager_sequences():
    """A sharded comm keeps the eager frame loop; the unfused engine, whose
    per-patch sums no longer read the host, makes a compiled sequence."""
    p = Params()
    assert isinstance(tpipe.make_sequence_fn(p, device="cpu", fused=False),
                      CompiledSequence)
    assert not isinstance(tpipe.make_sequence_fn(p, device="cpu", comm=_Sharded()),
                          CompiledSequence)


def test_facade_mixed_rnr_batch_equals_eager_frames():
    """A 4, 4, 3, 4-column batch: three uniform-RNR runs over two frames of
    the facade (RNR on, RNR off) == eager frames of each setting, chained."""
    p = Params()
    clouds = _clouds(31, 4)
    clouds[2] = clouds[2][:, :3]
    m = PatchworkPP(capacity=CAP, device="cpu")
    got = m.estimate_ground_sequence(clouds)
    frames = {True: tpipe.make_frame_fn(p, device="cpu"),
              False: tpipe.make_frame_fn(p.replace(enable_RNR=False), device="cpu")}
    st = init_state(p, device="cpu")
    for i, c in enumerate(clouds):
        st, r = frames[c.shape[1] == 4](st, torch.from_numpy(_padded(c)), len(c))
        np.testing.assert_array_equal(got[i].ground_mask, r.ground_mask.numpy()[: len(c)],
                                      err_msg=f"frame {i}")
    _assert_states_equal(st, m.state, "mixed batch")
    assert sorted(m._frames) == [(False, CAP, False), (True, CAP, False)]


def test_facade_frames_share_state_buffers_in_place(tmp_path):
    """One frame per (RNR, capacity), reused, all on the facade's state
    buffers; reset, load_state and state assignment write those buffers in
    place (a captured graph reads them at their addresses)."""
    p = Params()
    m = PatchworkPP(device="cpu")  # automatic capacity: 8192 or 16384 here
    small, big = _clouds(41, 2)
    big = np.concatenate([big, big + np.float32(0.01), big + np.float32(0.02)])
    ptrs = [getattr(m._state, k).data_ptr() for k in m._state.to_numpy()]
    m.estimate_ground(small)
    m.estimate_ground(small)
    m.estimate_ground(small[:, :3])
    m.estimate_ground(big)
    assert sorted(m._frames) == [(False, 8192, False), (True, 8192, False),
                                 (True, 16384, False)]
    assert all(cf.state is m._state for cf in m._frames.values())

    path = str(tmp_path / "state.npz")
    m.save_state(path)
    saved = m.state
    m.estimate_ground(small)
    m.load_state(path)
    _assert_states_equal(saved, m.state, "load_state")
    m.reset()
    _assert_states_equal(init_state(p, device="cpu"), m.state, "reset")
    m.state = saved
    _assert_states_equal(saved, m.state, "assignment")
    snapshot = m.state
    m.estimate_ground(small)
    with pytest.raises(AssertionError):
        _assert_states_equal(snapshot, m.state, "a snapshot is a copy")
    assert [getattr(m._state, k).data_ptr() for k in m._state.to_numpy()] == ptrs


def test_facade_last_result_survives_the_next_frame():
    """With the facade's frame replayed as a graph would be (outputs
    overwritten in place), last_result still holds its frame's values."""
    m = PatchworkPP(capacity=CAP, device="cpu")
    a, b = _clouds(51, 2)
    _install_replay(m._frame(True, CAP))
    m.estimate_ground(a)
    first = m.last_result
    kept = FrameResult(*(f.clone() for f in first))
    m.estimate_ground(b)
    _assert_results_equal(first, kept, "last_result after the next frame")
    eager = PatchworkPP(capacity=CAP, device="cpu")
    eager.estimate_ground(a)
    _assert_results_equal(kept, eager.last_result, "replayed vs eager facade")


class _Sharded(FrameComm):
    is_sharded = True


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this one process, for the whole test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["unfused", "sharded", "chunked", "cpu", "group",
                                  "shard_x_chunk"])
def test_capture_refuses_eager_frames(what, request):
    """Capture raises, the frame is left uncaptured and the state as it was.
    The unfused and the chunked frame (the unfused engine chunked too) are
    not eager: their ``eager_only`` is None, the capture refuses only their
    CPU buffers, and the compiled wrapper takes them for the card."""
    from patchworkpp_tpu_torch.graphs import _refusal
    from patchworkpp_tpu_torch.parallel.chunked import (
        chunked_step,
        make_chunked_frame_fn,
        make_sharded_chunked_frame_fn,
    )
    from patchworkpp_tpu_torch.parallel.point_sharded import GroupTransport, MeshComm
    from patchworkpp_tpu_torch.params import CZMGeometry

    p = Params()
    if what in ("group", "shard_x_chunk"):
        request.getfixturevalue("one_rank_group")
    frames = {
        "unfused": lambda: [tpipe.make_frame_fn(p, device="cpu", fused=False)],
        "sharded": lambda: [tpipe.make_frame_fn(p, device="cpu", comm=_Sharded())],
        "chunked": lambda: [make_chunked_frame_fn(p, 2, device="cpu"),
                            chunked_step(p, 4, CZMGeometry.create(p), False,
                                         torch.device("cpu"))],
        "cpu": lambda: [tpipe.make_frame_fn(p, device="cpu")],
        "group": lambda: [tpipe.make_frame_fn(p, device="cpu",
                                              comm=MeshComm(GroupTransport()))],
        "shard_x_chunk": lambda: [make_sharded_chunked_frame_fn(p, 2, device="cpu")],
    }[what]()
    eager = what in ("sharded", "group", "shard_x_chunk")
    match = {"sharded": "sharded comm", "group": "process group",
             "shard_x_chunk": "shard x chunk: .*process group"}.get(what, "CUDA tensors")
    for frame in frames:
        assert (_refusal(frame) is None) == (not eager)
        st = init_state(p, device="cpu")
        cf = CapturedFrame(frame, CAP, st)
        with pytest.raises(ValueError, match=match):
            cf.capture()
        assert not cf.is_captured
        _assert_states_equal(init_state(p, device="cpu"), st, "state after a refused capture")
        if what in ("unfused", "chunked"):  # built for the card, captured at first use
            assert not CompiledFrame(frame, p, device="cuda").frames
        elif eager:  # on the card the compiled wrapper refuses at once
            with pytest.raises(ValueError, match=match):
                CompiledFrame(frame, p, device="cuda")


def test_segment_matches_jax_segment():
    """pipeline.segment, chained over three clouds of two seeds: labels equal
    to the JAX segment's, state within the tiled engine's tolerances, bits
    equal to the eager frame's; the input state is not modified."""
    p, jp = Params(), JParams()
    frame = tpipe.make_frame_fn(p, device="cpu")
    for seed in (0, 2):
        ts = init_state(p, device="cpu")
        es = init_state(p, device="cpu")
        js = jstate.init_state(jp)
        for k, cloud in enumerate(_clouds(seed, 3)):
            pts = _padded(cloud)
            before = ts.clone()
            ts_new, tr = tpipe.segment(ts, torch.from_numpy(pts), len(cloud), p)
            _assert_states_equal(before, ts, "segment's input state")
            es, er = frame(es, torch.from_numpy(pts), len(cloud))
            js, jr = jpipe.segment(js, jnp.asarray(pts), jnp.int32(len(cloud)), jp)
            label = f"seed {seed} frame {k}"
            _assert_results_equal(tr, er, label)
            _assert_states_equal(es, ts_new, label)
            np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                          err_msg=label)
            _assert_state_close(js, ts_new, label)
            ts = ts_new


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_segment_from_two_threads_equals_serial_calls(device):
    """Two threads each chain 6 frames of their own clouds through
    pipeline.segment with equal Params (so one shared compiled frame),
    started together; each thread's results and states equal those of the
    same calls made one after another. On the card the second thread
    runs on a side stream."""
    import contextlib
    import sys
    import threading

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py makes this check on the card)")
    p = Params()
    streams = [_clouds(seed, 6) for seed in (0, 3)]

    def chain(clouds, out, start=None, stream=None):
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            st = init_state(p, device=device)
            if start is not None:
                start.wait()
            for cloud in clouds:
                pts = torch.from_numpy(_padded(cloud)).to(device)
                st, res = tpipe.segment(st, pts, len(cloud), p)
                out.append((st, res))
            if stream is not None:
                stream.synchronize()

    serial = [[], []]
    for clouds, out in zip(streams, serial):
        chain(clouds, out)
    together = [[], []]
    start = threading.Barrier(2)
    side = [None, torch.cuda.Stream() if device == "cuda" else None]
    threads = [threading.Thread(target=chain, args=(clouds, out, start, stream))
               for clouds, out, stream in zip(streams, together, side)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # hand the interpreter over often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if device == "cuda":
        torch.cuda.synchronize()
    for i, (want, got) in enumerate(zip(serial, together)):
        assert len(got) == len(want) == 6, f"thread {i}"
        for k, ((ws, wr), (gs, gr)) in enumerate(zip(want, got)):
            _assert_results_equal(gr, wr, f"thread {i} frame {k}")
            _assert_states_equal(ws, gs, f"thread {i} frame {k}")


def test_frame_report_counts_host_launch_calls():
    from patchworkpp_tpu_torch.utils import roofline

    def ev(name, start, on_device):
        return roofline.Event(name, float(start), 1.0, on_device, False, 0.0)

    events = [ev("cudaGraphLaunch", 0, False), ev("cudaMemcpyAsync", 2, False),
              ev("cudaLaunchKernel", 4, False), ev("aten::copy_", 1, False),
              ev("fit_program_kernel", 10, True), ev("elementwise_kernel", 12, True),
              ev("Memcpy DtoD (Device -> Device)", 3, True)]
    rep = roofline.frame_report(events, wall_s=100e-6, frames=1)
    assert rep["host_launch_calls_per_frame"] == 3
    assert rep["device_launches_per_frame"] == 3
