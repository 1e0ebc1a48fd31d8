"""The tiled frame against the JAX package's, with the sort's ties set aside.

The JAX tiled frame lays its points out with an unstable sort over (patch,
z) (``patchworkpp_tpu/ops/tiled.py:build_tiled``); the port's sort is
stable (``patchworkpp_tpu_torch/ops/tiled.py``). Rows whose keys are
bit-identical may so land in other places, and a tile adds its rows in
order, so a moment sum can move by an ulp: on frame 6 of the 64-beam chain
it moves one patch's flatness (tests/test_torch_state_update.py pins it).

Here the two layouts are shown to differ by exactly that freedom (every
tile holds the same rows, and a row moves only among rows of its own
patch and z), and the port's frame, handed the JAX layout's row order, is
shown to give the JAX frame's every bit: labels, patch eigenvalues and
every state field, on frames 0-6 of ``io/synthetic.make_scan(0, k)`` at
capacity 131072 and on the fuzz clouds of tests/test_fuzz_parity.py, fresh
and chained. With its own order the port's eigenvalues equal the JAX
frame's on the fuzz clouds too (their tied rows are duplicates, whose order
changes nothing).
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import patchworkpp_tpu.state as jstate  # noqa: E402
import patchworkpp_tpu_torch.pipeline as tpipe  # noqa: E402
from patchworkpp_tpu.params import Params as JParams  # noqa: E402
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn  # noqa: E402
from patchworkpp_tpu_torch import Params, init_state  # noqa: E402
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_scan  # noqa: E402
from test_fuzz_parity import CAP, synth_cloud  # noqa: E402
from test_torch_frame import _one_torch_thread  # noqa: E402, F401
from test_torch_state_update import _state_diff  # noqa: E402


def _ties_script():
    """scripts/xla_cpu_sort_ties.py, whose layout helpers these tests use."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "xla_cpu_sort_ties.py"
    spec = importlib.util.spec_from_file_location("xla_cpu_sort_ties", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TIES = _ties_script()


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _pad(cloud, capacity):
    pts = np.zeros((capacity, 4), np.float32)
    pts[: len(cloud)] = cloud
    return pts


@pytest.fixture(scope="module")
def jax_frame():
    return jax.jit(j_make_frame_fn(JParams()))


def _run(jax_frame, monkeypatch, clouds, capacity, chained, tie_order):
    """Each cloud through the JAX tiled frame and the port's (with the JAX
    layout's row order where ``tie_order``); yields both results and the
    states' differing entries."""
    if tie_order:
        monkeypatch.setattr(tpipe, "build_tiled", TIES.build_tiled_jax_order)
    frame = tpipe.make_frame_fn(Params(), device="cpu")
    js = ts = None
    for cloud in clouds:
        if js is None or not chained:
            js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
        pts = _pad(cloud, capacity)
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = frame(ts, torch.from_numpy(pts), len(cloud))
        yield jr, tr, _state_diff(js, ts)


def _assert_same(jr, tr, diff, label):
    np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                  err_msg=label)
    np.testing.assert_array_equal(_bits(tr.patch_svals.numpy()), _bits(jr.patch_svals),
                                  err_msg=f"{label}: patch_svals")
    assert diff == {}, label


def test_layouts_differ_only_among_tied_rows():
    """Frame 0 of the chain: the same tiles, and within each (patch, z)
    group of rows the same rows in another order; dozens of rows move."""
    cloud = make_scan(0, 0)
    frame = tpipe.make_frame_fn(Params(), device="cpu")
    tp, jrows = TIES.layouts(frame, init_state(Params(), device="cpu"),
                             _pad(cloud, CAPACITY), len(cloud))
    port = tp.xyz.numpy()
    jax_rows = jrows.numpy()
    moved = (_bits(port) != _bits(jax_rows)).any(1)
    assert 20 < moved.sum() < 1000
    # the same multiset of rows within each (patch, z) key
    key = np.stack([tp.patch_id.numpy().astype(np.float64), port[:, 2]], 1)
    np.testing.assert_array_equal(_bits(port[:, 2]), _bits(jax_rows[:, 2]))
    for k in np.unique(key[moved], axis=0):
        rows = (key == k).all(1)
        a = np.sort(port[rows].view(np.uint32).view([("", np.uint32)] * 3), axis=0)
        b = np.sort(jax_rows[rows].view(np.uint32).view([("", np.uint32)] * 3), axis=0)
        np.testing.assert_array_equal(a, b)


def test_64_beam_chain_with_jax_tie_order_bit_equal(jax_frame, monkeypatch):
    """Frames 0-6 of the chain, the frame-6 flatness included."""
    clouds = [make_scan(0, k) for k in range(7)]
    for k, (jr, tr, diff) in enumerate(_run(jax_frame, monkeypatch, clouds, CAPACITY,
                                            True, True)):
        _assert_same(jr, tr, diff, f"frame {k}")


@pytest.mark.parametrize("tie_order", [False, True], ids=["port order", "jax order"])
@pytest.mark.parametrize("chained", [False, True], ids=["fresh", "chained"])
@pytest.mark.parametrize("edges", [True, False], ids=["edges", "clean"])
def test_fuzz_streams_bit_equal(jax_frame, monkeypatch, edges, chained, tie_order):
    """The fuzz clouds (seeds 0-4), fresh and chained: labels, eigenvalues
    and state bit for bit, with either row order."""
    clouds = [synth_cloud(s, exact_edges=edges) for s in range(5)]
    for s, (jr, tr, diff) in enumerate(_run(jax_frame, monkeypatch, clouds, CAP, chained,
                                            tie_order)):
        _assert_same(jr, tr, diff, f"seed {s}")
