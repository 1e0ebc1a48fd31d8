#!/usr/bin/env python
"""How often does the JAX tiled frame's unstable sort move the port's bits?

The JAX package lays points out for the fit with one unstable sort over
(patch, z) (``patchworkpp_tpu/ops/tiled.py:build_tiled``,
``jax.lax.sort(..., is_stable=False)``); the port sorts stably
(``patchworkpp_tpu_torch/ops/tiled.py``). Rows whose (patch, z) keys are
bit-identical may land in another order, and a tile's moment sums add its
rows in order, so a covariance can move by an ulp, and with it a patch's
eigenvalues and the flatness that the adaptive state keeps. Which order
XLA:CPU leaves tied rows in is the runtime sort's own choice (the optimized
HLO keeps ``sort(...)`` as one instruction, printed below), not a rounding
of the program that another one could mirror.

For each frame of each stream the script prints, as one JSON line:

- ``tie_rows``: layout rows whose (x, y, z) differ between the JAX
  package's jitted ``build_tiled`` and the port's on the same input;
- ``svals``, ``state``, ``labels``: patches whose eigenvalues differ, state
  entries whose bits differ (by field) and labels that differ, the JAX
  tiled frame (``jax.jit(make_frame_fn(Params()))``) against the port's
  (``make_frame_fn(Params(), device="cpu")``), states chained per stream;
- ``normals``, ``normals_max_abs``: patch normal entries whose bits differ,
  and the largest difference (the normals are not held to bits: a
  clustered pair's follows XLA:CPU's host-dependent ``rsqrt``);
- ``svals_tied``, ``state_tied``, ``normals_tied``: the same with the JAX
  layout's row order handed to the port's frame (the first two are 0 when
  the tie order is the only difference).

Streams: ``FRAMES`` (20) chained frames of ``io/synthetic.make_scan(0, k)``
at capacity 131072, and the fuzz clouds of
``tests/test_fuzz_parity.py:synth_cloud`` (seeds 0-4, probes on and off the
edges) at capacity 8192, fresh (each from the initial state) and chained.
The last line sums every column.

The layout helpers (:func:`jax_rows`, :func:`build_tiled_jax_order`,
:func:`layouts`) are also what ``tests/test_torch_sort_ties.py`` holds the
two layouts and frames with.

Usage: JAX_PLATFORMS=cpu python scripts/xla_cpu_sort_ties.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import patchworkpp_tpu.state as jstate  # noqa: E402
import patchworkpp_tpu_torch.pipeline as tpipe  # noqa: E402
from patchworkpp_tpu.params import Params as JParams  # noqa: E402
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn  # noqa: E402
from patchworkpp_tpu_torch import Params, init_state  # noqa: E402
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_scan  # noqa: E402
from patchworkpp_tpu_torch.ops.tiled import build_tiled  # noqa: E402
from patchworkpp_tpu.ops.tiled import build_tiled as j_build_tiled  # noqa: E402
from test_fuzz_parity import CAP, synth_cloud  # noqa: E402

FRAMES = 20
_J_BUILD = jax.jit(j_build_tiled, static_argnames=("width",))


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def jax_rows(xyz, patch_id, counts, width):
    """The JAX package's jitted layout of one binning, and its rows' (x, y,
    z) as a tensor."""
    t = _J_BUILD(jnp.asarray(xyz.numpy()), jnp.asarray(patch_id.numpy()),
                 jnp.asarray(counts.numpy()), width=width)
    return t, torch.from_numpy(np.asarray(t.xyz).copy())


def build_tiled_jax_order(xyz, patch_id, counts=None, width=512):
    """The port's layout with the JAX layout's row order (in place of
    ``pipeline.build_tiled``); every other field of the two layouts must be
    equal."""
    tp = build_tiled(xyz, patch_id, counts, width)
    jt, rows = jax_rows(xyz, patch_id, tp.counts, width)
    for f in ("valid", "patch_id", "tile_patch", "counts", "pad_start"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    return tp._replace(xyz=rows)


def layouts(fr, state, pts, npts):
    """The port's layout of frame ``fr``'s binning of ``pts`` and the JAX
    layout's rows of the same binning."""
    got = []

    def grab(xyz, patch_id, counts=None, width=512):
        tp = build_tiled(xyz, patch_id, counts, width)
        got.append((tp, jax_rows(xyz, patch_id, tp.counts, width)[1]))
        return tp

    tpipe.build_tiled = grab
    try:
        fr.fit_inputs(state, torch.as_tensor(pts), npts)
    finally:
        tpipe.build_tiled = build_tiled
    return got[0]


def state_diff(js, ts) -> dict:
    a, b = js.to_numpy(), ts.to_numpy()
    return {k: int((bits(a[k]) != bits(b[k])).sum()) for k in a
            if (bits(a[k]) != bits(b[k])).any()}


def tie_rows(fr, state, pts, npts) -> int:
    """Layout rows whose coordinates differ between the two sorts of one
    binning."""
    port, rows = layouts(fr, state, pts, npts)
    return int((bits(port.xyz.numpy()) != bits(rows.numpy())).any(1).sum())


def run_stream(name, clouds, capacity, chained, jframe, fr, rows) -> None:
    """One stream through the JAX tiled frame and the port's, the port's
    with its own row order and with the JAX layout's."""
    js = ts = tt = None
    for k, cloud in enumerate(clouds):
        if js is None or not chained:
            js = jstate.init_state(JParams())
            ts = init_state(Params(), device="cpu")
            tt = init_state(Params(), device="cpu")
        pts = np.zeros((capacity, 4), np.float32)
        pts[:len(cloud)] = cloud
        row = {"stream": name, "frame": k, "tie_rows": tie_rows(fr, ts, pts, len(cloud))}
        js, jr = jframe(js, jnp.asarray(pts), jnp.int32(len(cloud)))
        ts, tr = fr(ts, torch.from_numpy(pts), len(cloud))
        tpipe.build_tiled = build_tiled_jax_order
        try:
            tt, tq = fr(tt, torch.from_numpy(pts), len(cloud))
        finally:
            tpipe.build_tiled = build_tiled
        row["labels"] = int((np.asarray(jr.ground_mask) != tr.ground_mask.numpy()).sum())
        for sfx, st, res in (("", ts, tr), ("_tied", tt, tq)):
            row["svals" + sfx] = int((bits(jr.patch_svals)
                                      != bits(res.patch_svals.numpy())).any(1).sum())
            row["state" + sfx] = state_diff(js, st)
            nj, nt = np.asarray(jr.patch_normal), res.patch_normal.numpy()
            row["normals" + sfx] = int((bits(nj) != bits(nt)).sum())
            row["normals_max_abs" + sfx] = float(np.abs(nj - nt).max())
        print(json.dumps(row), flush=True)
        rows.append(row)


def main() -> None:
    torch.set_num_threads(1)
    jframe = jax.jit(j_make_frame_fn(JParams()))
    hlo = jframe.lower(jstate.init_state(JParams()), jnp.zeros((CAP, 4), jnp.float32),
                       jnp.int32(0)).compile().as_text()
    print(json.dumps({"sort_hlo": [ln.strip().split(", metadata")[0]
                                   for ln in hlo.splitlines() if " sort(" in ln]}))
    fr = tpipe.make_frame_fn(Params(), device="cpu")
    rows: list = []
    run_stream("make_scan(0, k)", [make_scan(0, k) for k in range(FRAMES)], CAPACITY,
               True, jframe, fr, rows)
    for edges in (True, False):
        clouds = [synth_cloud(s, exact_edges=edges) for s in range(5)]
        for chained in (False, True):
            name = f"synth_cloud edges={edges} {'chained' if chained else 'fresh'}"
            run_stream(name, clouds, CAP, chained, jframe, fr, rows)
    total = {k: sum(r[k] for r in rows)
             for k in ("tie_rows", "svals", "labels", "svals_tied", "normals", "normals_tied")}
    total["state_frames"] = sum(bool(r["state"]) for r in rows)
    total["state_tied_frames"] = sum(bool(r["state_tied"]) for r in rows)
    total["frames"] = len(rows)
    print(json.dumps({"total": total}))


if __name__ == "__main__":
    main()
