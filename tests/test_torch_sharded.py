"""The port's multi-process paths over torch.distributed (gloo, CPU
processes that the tests spawn; parallel/point_sharded.py, sharded.py and
the shard x chunk composition of chunked.py) against the chunked frame,
the single-device frame and facade, and the JAX package's point-sharded
mesh program (the 8 virtual CPU devices of tests/conftest.py).

One run of scripts/torch_multiproc_parity.py at 2 ranks and one at 4
(started together, each under a timeout, so a hang fails instead of
stalling the suite) write every rank's results as npz files: the
point-sharded frames 0 and 1 of io/synthetic.make_scan(0, 0..2)[::16] at
capacity 8192, the 3-frame chain through the sequence and through the
frame loop, the shard x chunk composition (ranks x 2 chunks) and one
frame-parallel stream per rank. Between the port's own paths every
FrameResult field and the state are equal bit for bit; against the JAX
mesh program and the facades, the labels are equal. In this process, over
a one-rank gloo group, the frame-parallel step (its streams through one
``graphs.CompiledFrame``, eager on the CPU) equals the eager frame loop of
each stream bit for bit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist
from jax.sharding import Mesh

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.parallel import make_point_sharded_frame_fn as j_point_sharded
from patchworkpp_tpu_torch import Params, PatchworkPP, init_state
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.parallel import (
    batch_init_state,
    make_batch_frame_fn,
    make_chunked_frame_fn,
    make_point_sharded_frame_fn,
    make_sharded_chunked_frame_fn,
)
from patchworkpp_tpu_torch.parallel.selfcheck import dryrun_multiproc
from patchworkpp_tpu_torch.pipeline import make_frame_fn, make_sequence_fn
from test_torch_frame import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_multiproc_parity.py"
CAP, SUB, FRAMES = 8192, 16, 3
RANKS = (2, 4)
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{ranks: (exit code, stdout, [each rank's arrays])} of the parity
    script at 2 and 4 ranks."""
    procs = {}
    for n in RANKS:
        out = tmp_path_factory.mktemp(f"ranks{n}")
        procs[n] = (out, subprocess.Popen(
            [sys.executable, str(SCRIPT), "--nprocs", str(n), "--device", "cpu",
             "--out", str(out), "--timeout", str(TIMEOUT - 30)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    result = {}
    for n, (out, proc) in procs.items():
        try:
            text, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            pytest.fail(f"{n} ranks: the parity script hung\n{text}")
        ranks = [dict(np.load(p)) for p in sorted(out.glob("rank*.npz"))]
        result[n] = (proc.returncode, text, ranks)
    return result


@pytest.fixture(scope="module")
def frames():
    stack = np.zeros((FRAMES, CAP, 4), np.float32)
    npts = []
    for f in range(FRAMES):
        c = make_scan(0, f)[::SUB]
        stack[f, : len(c)] = c
        npts.append(len(c))
    return stack, npts


def _fields(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _flat(state, res) -> dict:
    out = {f: getattr(res, f).numpy() for f in res._fields}
    out.update({f"state_{k}": v for k, v in state.to_numpy().items()})
    return out


def _assert_equal(got: dict, want: dict, label: str):
    assert sorted(got) == sorted(want), label
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("n", RANKS)
def test_multiproc_parity_script_passes(runs, n):
    rc, text, ranks = runs[n]
    assert rc == 0, text
    assert json.loads(text.strip().splitlines()[-1]) == {"multiproc_parity": "PASS"}
    assert text.count("PASS ") == 5 and "FAIL" not in text
    assert len(ranks) == n


@pytest.mark.parametrize("n", RANKS)
def test_point_sharded_equals_chunked(runs, frames, n):
    """Every rank's point-sharded frame == the chunked frame at K = ranks,
    on every FrameResult field and the state, bit for bit."""
    stack, npts = frames
    p = Params()
    fn = make_chunked_frame_fn(p, n, device="cpu")
    for f in range(2):
        want = _flat(*fn(init_state(p, device="cpu"), torch.from_numpy(stack[f]), npts[f]))
        for r, got in enumerate(runs[n][2]):
            _assert_equal(_fields(got, f"ps{f}_"), want, f"{n} ranks, rank {r}, frame {f}")


@pytest.mark.parametrize("n", RANKS)
def test_point_sharded_labels_equal_jax_mesh(runs, frames, n):
    stack, npts = frames
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    jfn = j_point_sharded(JParams(), mesh, axis="d")
    for f in range(2):
        _, jres = jfn(jstate.init_state(JParams()), jnp.asarray(stack[f]), jnp.int32(npts[f]))
        np.testing.assert_array_equal(runs[n][2][0][f"ps{f}_ground_mask"],
                                      np.asarray(jres.ground_mask), err_msg=f"frame {f}")


@pytest.mark.parametrize("n", RANKS)
def test_chain_equals_frame_loop(runs, frames, n):
    """The point-sharded sequence == its frame loop bit for bit (results of
    each frame and the final state); its labels == the single-device
    sequence's."""
    stack, npts = frames
    _, res = make_sequence_fn(Params(), device="cpu")(
        init_state(Params(), device="cpu"), torch.from_numpy(stack), npts)
    for r, got in enumerate(runs[n][2]):
        for f in range(FRAMES):
            _assert_equal(_fields(got, f"chain{f}_"), _fields(got, f"loop{f}_"),
                          f"rank {r} frame {f}")
            np.testing.assert_array_equal(got[f"chain{f}_ground_mask"],
                                          res.ground_mask[f].numpy())
        _assert_equal(_fields(got, "chain_state_"), _fields(got, "loop_state_"), f"rank {r}")


@pytest.mark.parametrize("n", RANKS)
def test_frame_parallel_equals_per_stream_facades(runs, frames, n):
    stack, npts = frames
    for b in range(n):
        f = b % FRAMES
        m = PatchworkPP(capacity=CAP, device="cpu")
        res = m.estimate_ground(stack[f, : npts[f]])
        for r, got in enumerate(runs[n][2]):
            np.testing.assert_array_equal(got[f"fp{b}_ground_mask"][: npts[f]], res.ground_mask,
                                          err_msg=f"rank {r} stream {b}")
            for k, v in m.state.to_numpy().items():
                np.testing.assert_array_equal(got[f"fp{b}_state_{k}"], v)


def test_composition_2x2_equals_flat_group_of_4(runs):
    """2 ranks x 2 chunks == 4 ranks, bit for bit: both reduce over the same
    four row blocks in the same order."""
    for r in range(2):
        _assert_equal(_fields(runs[2][2][r], "sxc_"), _fields(runs[4][2][0], "ps0_"),
                      f"rank {r}")


def test_group_of_one_is_plain_frame(frames, tmp_path):
    """A group of one rank gives the plain frame with the identity comm (K1
    on the card), the composition at one chunk too; the frame-parallel
    step runs it per stream."""
    stack, npts = frames
    p = Params()
    x = torch.from_numpy(stack[0])
    _, want = make_frame_fn(p, device="cpu")(init_state(p, device="cpu"), x, npts[0])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        fn = make_point_sharded_frame_fn(p, device="cpu")
        assert hasattr(fn, "fit_inputs")  # the plain fused frame's
        assert hasattr(make_sharded_chunked_frame_fn(p, 1, device="cpu"), "fit_inputs")
        _, res = fn(init_state(p, device="cpu"), x, npts[0])
        _, bres = make_batch_frame_fn(p, device="cpu")(
            batch_init_state(p, 1, "cpu"), x[None], npts[:1])
    finally:
        dist.destroy_process_group()
    for f in want._fields:
        np.testing.assert_array_equal(getattr(res, f).numpy(), getattr(want, f).numpy())
        np.testing.assert_array_equal(getattr(bres, f)[0].numpy(), getattr(want, f).numpy())


def test_frame_parallel_compiled_equals_eager_loop(frames, tmp_path):
    """Three streams, two chained batch calls (``npts`` as ints, then as a
    tensor whose entries stay tensors): each stream's results and state
    equal its own eager frame loop's, every field bit for bit."""
    stack, npts = frames
    p = Params()
    frame = make_frame_fn(p, device="cpu")
    states = [init_state(p, device="cpu") for _ in range(FRAMES)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        fn = make_batch_frame_fn(p, device="cpu")
        bst = batch_init_state(p, FRAMES, "cpu")
        for call, n in enumerate((npts, torch.tensor(npts, dtype=torch.int32))):
            pts = torch.from_numpy(np.roll(stack, call, axis=0).copy())
            counts = n.roll(call) if isinstance(n, torch.Tensor) else list(np.roll(n, call))
            bst, bres = fn(bst, pts, counts)
            for b in range(FRAMES):
                states[b], want = frame(states[b], pts[b], int(counts[b]))
                for f in want._fields:
                    np.testing.assert_array_equal(getattr(bres, f)[b].numpy(),
                                                  getattr(want, f).numpy(),
                                                  err_msg=f"call {call} stream {b} {f}")
                for k, v in states[b].to_numpy().items():
                    np.testing.assert_array_equal(getattr(bst, k)[b].numpy(), v,
                                                  err_msg=f"call {call} stream {b} {k}")
    finally:
        dist.destroy_process_group()


def test_dryrun_multiproc_2x2():
    """parallel/selfcheck.py over 4 processes: a 2 x 2 ("frame", "point")
    split by dist.new_group and every scaling path, exact against the
    single-process frame."""
    dryrun_multiproc(4, device="cpu", timeout=TIMEOUT)


def test_self_checks_default_to_cuda_and_refuse_without_it(monkeypatch):
    """The parity script and the self-check run on the card unless given
    the CPU, and raise before spawning a rank when there is no card."""
    import importlib.util

    from patchworkpp_tpu_torch.parallel import selfcheck

    spec = importlib.util.spec_from_file_location("torch_multiproc_parity", SCRIPT)
    parity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parity)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(selfcheck, "spawn", lambda *a, **k: spawned.append(a))
    for call in (lambda: parity.main(["--nprocs", "2"]),
                 lambda: selfcheck.main(["--n", "2"]),
                 lambda: dryrun_multiproc(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not spawned
    dryrun_multiproc(2, device="cpu")
    assert spawned and spawned[0][2] == ("cpu",)
