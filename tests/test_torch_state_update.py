"""The port's adaptive-state update against the JAX package's, bit for bit.

The JAX frame sums each ring's (1064,) threshold buffer with ``jnp.sum`` as
XLA:CPU compiles it: 32-wide windows, the row zero-padded to a multiple of
32 with half the padding on each side, repeated on the window sums, the
last 32 or fewer summed in order (``ops.row_sum``). It also fuses the ring
thresholds' ``mean + factor * stdev`` (and TGR's ``mean + 1.5 * stdev``)
into one fused multiply-add (``ops.fma``). With both, the port's state
carries the JAX engine's bits:

- ``row_sum`` equals the jitted ``jnp.sum`` of a row at lengths from 5 to
  5000, and keeps the bits of its 128-lane callers (the tile sums);
  ``row_sums`` of several tensors gives each one's ``row_sum`` bits;
- ``pipeline._update_state`` equals the jitted JAX ``_update_state`` on the
  fuzz streams of tests/test_state_update.py and on streams with random
  storage caps, every state field after every frame;
- on io/synthetic.py's 64-beam chain (``make_scan(0, k)``, capacity
  131072) every state field equals the JAX tiled engine's on frames 0-5,
  the labels on frames 0-6, and the eigenvalues of every patch on every
  frame but one patch of frame 6. There frame 6 appends one flatness whose
  bits differ: the JAX layout's unstable sort leaves rows with equal
  (patch, z) keys in another order than the port's stable one, a tile sums
  its rows in order, and patch 9's y*y moment comes out one ulp apart, so
  its covariance and eigenvalues do (tests/test_torch_sort_ties.py hands
  the port the JAX row order and gets every bit). The test pins that
  difference to those entries.

The JAX ``_update_state`` is jitted, as it runs inside the frame: op by op,
XLA neither reorders the sums into windows nor fuses the multiply-add.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import patchworkpp_tpu.state as jstate  # noqa: E402
import patchworkpp_tpu_torch.pipeline as tpipe  # noqa: E402
from patchworkpp_tpu.params import Params as JParams  # noqa: E402
from patchworkpp_tpu.pipeline import _update_state as j_update_state  # noqa: E402
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn  # noqa: E402
from patchworkpp_tpu_torch import Params, init_state  # noqa: E402
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_scan  # noqa: E402
from patchworkpp_tpu_torch.ops import ROW_WINDOW, row_sum, row_sums, seq_sum  # noqa: E402
from test_state_update import _random_frames  # noqa: E402
from test_torch_frame import _one_torch_thread  # noqa: E402, F401

ROW_LENGTHS = (5, 32, 33, 100, 128, 504, 1001, 1063, 1064, 5000)


def _bits(a) -> np.ndarray:
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


def _state_diff(js, ts) -> dict:
    """{field: indices whose bits differ} of two states (empty if equal);
    every field is 4-byte float32 or int32."""
    jn, tn = js.to_numpy(), ts.to_numpy()
    # the port's state also carries the last plane, which the JAX state lacks
    assert sorted(tn) == sorted([*jn, "plane"])
    out = {}
    for k in jn:
        a, b = np.atleast_1d(jn[k]), np.atleast_1d(tn[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        where = np.argwhere(a.view(np.int32) != b.view(np.int32))
        if len(where):
            out[k] = [tuple(int(i) for i in ix) for ix in where]
    return out


@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_row_sum_matches_jitted_jnp_sum(n):
    """Seeded rows whose magnitudes span many binades, some entries zero."""
    rng = np.random.default_rng(n)
    v = (rng.normal(size=(160, n)) * np.exp(rng.uniform(-6, 6, (160, 1)))
         * (rng.uniform(size=(160, n)) < 0.8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda t: jnp.sum(t, axis=-1))(v))
    got = row_sum(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", (32, 128, 1024))
def test_row_sum_keeps_one_window_level_for_its_tile_callers(n):
    """A multiple of 32 up to 1024 needs no padding and one level of
    windows: the order the fit kernels and the tile sums were written to."""
    rng = np.random.default_rng(100 + n)
    v = torch.from_numpy((rng.normal(size=(64, n))
                          * np.exp(rng.uniform(-8, 8, (64, 1)))).astype(np.float32))
    want = seq_sum(seq_sum(v.reshape(64, n // ROW_WINDOW, ROW_WINDOW)))
    assert torch.equal(row_sum(v).view(torch.int32), want.view(torch.int32))


def test_row_sums_share_levels_and_keep_each_rows_bits():
    """Rows of several lengths summed together (the frame's state buffers
    and TGR's rows share their window steps) give each tensor's own
    ``row_sum`` bits."""
    rng = np.random.default_rng(5)
    vs = [torch.from_numpy((rng.normal(size=(r, n)) * np.exp(rng.uniform(-6, 6, (r, 1)))
                            ).astype(np.float32))
          for r, n in ((8, 1064), (4, 128), (3, 33), (2, 5), (5, 5000))]
    for v, got in zip(vs, row_sums(*vs)):
        assert torch.equal(got.view(torch.int32), row_sum(v).view(torch.int32)), v.shape


def _named_streams():
    """The fuzz streams of tests/test_state_update.py, by its seeds."""
    rng = np.random.default_rng(7)
    yield "trims (seed 7)", dict(max_elevation_storage=23, max_flatness_storage=19), \
        _random_frames(rng, 4, 32, 40, 0.4)
    rng = np.random.default_rng(11)
    frames = []
    for t in range(30):
        acc = rng.random((4, 16)) < 0.5
        if t < 3:
            acc[1] = False
        if t % 7 == 3:
            acc[2] = False
        e_vals = rng.normal(-1.7, 0.3, (4, 16)).astype(np.float32) * acc
        f_vals = rng.random((4, 16)).astype(np.float32) * 0.02 * acc
        frames.append((acc, e_vals, f_vals))
    yield "freeze cascade (seed 11)", dict(max_elevation_storage=50,
                                           max_flatness_storage=50), frames
    rng = np.random.default_rng(3)
    frames = []
    for t in range(12):
        acc = np.full((4, 24), t % 2 == 1)
        e_vals = rng.normal(-1.7, 0.2, (4, 24)).astype(np.float32) * acc
        f_vals = rng.random((4, 24)).astype(np.float32) * 0.01 * acc
        frames.append((acc, e_vals, f_vals))
    yield "empty and full rows (seed 3)", dict(max_elevation_storage=40,
                                               max_flatness_storage=40), frames
    rng = np.random.default_rng(5)
    yield "default storage, long (seed 5)", {}, _random_frames(rng, 4, 32, 70, 0.5)


def _random_cap_stream(seed):
    """Storage caps, row width and acceptance rate drawn from ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    caps = dict(max_elevation_storage=int(rng.integers(2, 1000)),
                max_flatness_storage=int(rng.integers(2, 1000)))
    w = int(rng.choice([8, 16, 32]))
    return caps, _random_frames(rng, 4, w, 40, float(rng.uniform(0.1, 0.9)))


STREAMS = [(label, kw, frames) for label, kw, frames in _named_streams()] + [
    (f"random caps {s}", *_random_cap_stream(s)) for s in range(5)]


@pytest.fixture(scope="module")
def jax_update_state():
    return jax.jit(j_update_state, static_argnums=1)


@pytest.mark.parametrize("stream", STREAMS, ids=lambda s: s[0])
def test_update_state_matches_jax_bit_for_bit(jax_update_state, stream):
    label, kw, frames = stream
    jp, p = JParams(**kw), Params(**kw)
    js, ts = jstate.init_state(jp), init_state(p, device="cpu")
    for i, (acc, e_vals, f_vals) in enumerate(frames):
        e_vals = np.asarray(e_vals, np.float32)
        f_vals = np.asarray(f_vals, np.float32)
        js = jax_update_state(js, jp, jnp.asarray(acc), jnp.asarray(e_vals),
                              jnp.asarray(f_vals))
        ts, _ = tpipe._update_state(ts, p, torch.from_numpy(acc), torch.from_numpy(e_vals),
                                    torch.from_numpy(f_vals))
        assert _state_diff(js, ts) == {}, f"{label}, frame {i}"


# Frame 6 of the chain: the one flatness (ring 0, slot 105, patch 9) and the
# threshold computed from it, whose bits differ, and that patch's
# eigenvalues. Not mirrorable (ROADMAP, queue 3): the JAX frame's layout
# sort is unstable (jax.lax.sort(..., is_stable=False), one sort(...)
# instruction in the optimized HLO that XLA:CPU's runtime runs), and the
# order it leaves tied rows in is the runtime's choice; the port sorts
# stably on the CPU and the card alike. Its tiled layout of frame 6 holds 164
# rows in another place than the JAX layout's (scripts/xla_cpu_sort_ties.py).
FRAME6_KNOWN = {"flat_buf": [(0, 105)], "flatness_thr": [(0,)]}
FRAME6_SVALS = [9]


def test_64_beam_chain_state_bit_equal_to_jax():
    jax_frame = jax.jit(j_make_frame_fn(JParams()))
    torch_frame = tpipe.make_frame_fn(Params(), device="cpu")
    js, ts = jstate.init_state(JParams()), init_state(Params(), device="cpu")
    for k in range(7):
        cloud = make_scan(0, k)
        pts = np.zeros((CAPACITY, 4), np.float32)
        pts[: len(cloud)] = cloud
        js, jr = jax_frame(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = torch_frame(ts, torch.from_numpy(pts), len(cloud))
        np.testing.assert_array_equal(tr.ground_mask.numpy(), np.asarray(jr.ground_mask),
                                      err_msg=f"frame {k}")
        sv = (_bits(jr.patch_svals).reshape(-1, 12)
              != _bits(tr.patch_svals.numpy()).reshape(-1, 12)).any(1)
        assert np.nonzero(sv)[0].tolist() == (FRAME6_SVALS if k == 6 else []), f"frame {k}"
        diff = _state_diff(js, ts)
        if k < 6:
            assert diff == {}, f"frame {k}"
            continue
        for key, where in diff.items():
            assert set(where) <= set(FRAME6_KNOWN.get(key, [])), (key, where)
            a, b = js.to_numpy()[key], ts.to_numpy()[key]
            for ix in where:
                assert abs(float(a[ix]) - float(b[ix])) <= 1e-4 * abs(float(a[ix])), (key, ix)
