"""The fit program's plain version (port ops/tiled_fit.py, the CPU path of
the CUDA fit kernel) vs the JAX package's ``tiled_fit`` and its Pallas grid
kernel ``fused_fit_grid`` (interpret mode), at capacity 8192.

Both sides get the SAME tiled inputs (built once by the port's frame from
``synth_cloud``), so the comparison isolates the fit program. Integer
columns (n, g_count, the R-VPF snapshot gates) must be equal. Float
columns agree to a few ulp: the tile sums follow XLA:CPU's order
(``ops.row_sum``) and the fit math its fused multiply-adds (``ops.fma``),
but the one-hot dot that adds a patch's tiles in the JAX engine has its own
order, and a clustered pair's normal its own 1/sqrt
(tests/test_torch_eigen.py). The tolerance is atol 5e-5 + rtol 5e-5, under
a tenth of the 0.125 m th_dist margin any label decision reads, and the
worst difference is printed. On the synthetic 64-beam scan the entries
beyond 5e-5 are counted (plane offsets d of clustered pairs, 30 m from the
sensor) and held under a bound.

The crowded-patch and one-tile clouds of ``io/synthetic.py`` (capacity
131072) drive the kernels' two row sources on the card (a patch longer than
their shared-memory cap is staged chunk by chunk); here their plain fits are
held against JAX's under the same tolerance. Two binding tests check what no CPU
run of a kernel can: that each wrapper's ctypes argument types follow the
``extern "C"`` signature (a pointer passed as an int is cut to 32 bits), and
that the wrapper's ``CAP_TILES`` is the source's ``kCapTiles``.

The test marked ``gpu`` holds the CUDA kernel against the plain version on
the card; it skips where there is no CUDA device.
"""

from __future__ import annotations

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu.ops.onehot import patch_lookup as j_patch_lookup
from patchworkpp_tpu.ops.pallas import fit_kernel_grid as j_fkg
from patchworkpp_tpu.ops.tiled_fit import _rne_bf16_split3 as j_split3
from patchworkpp_tpu.ops.tiled_fit import out_layout as j_out_layout
from patchworkpp_tpu.ops.tiled_fit import tiled_fit as j_tiled_fit
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.pipeline import FrameComm
from patchworkpp_tpu_torch.io.synthetic import (
    CAPACITY,
    make_crowded_scan,
    make_one_tile_scan,
    make_scan,
)
from patchworkpp_tpu_torch import CZMGeometry, Params, init_state
from patchworkpp_tpu_torch.ops import fit_kernel as fk
from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns
from patchworkpp_tpu_torch.ops.fit_kernel import OUT_COLS, OUT_COV, OUT_GCOUNT, OUT_N, OUT_SVALS
from patchworkpp_tpu_torch.ops.tiled_fit import (
    _reduce_tiles_split3,
    _rne_bf16_split3,
    out_layout,
    tile_ranges,
    tiled_fit,
)
from patchworkpp_tpu_torch.pipeline import build_static_tables, make_frame_fn
from test_fuzz_parity import CAP, synth_cloud
from test_torch_frame import _one_torch_thread  # noqa: F401

ATOL, RTOL = 5e-5, 5e-5
PAD_COL = 15  # unused column of the 48-column table


def _cloud_fit_inputs(cloud: np.ndarray, p: Params, capacity: int):
    pts = np.zeros((capacity, 4), np.float32)
    pts[: len(cloud)] = cloud
    return make_frame_fn(p, device="cpu").fit_inputs(
        init_state(p, device="cpu"), torch.from_numpy(pts), len(cloud)
    )


def _fit_inputs(seed: int, p: Params, exact_edges: bool = False):
    """The port frame's fit inputs for synth_cloud(seed) at capacity 8192."""
    return _cloud_fit_inputs(synth_cloud(seed, exact_edges=exact_edges), p, CAP)


def _processed_tiles(fi) -> torch.Tensor:
    return ((fi.pad_start[1:] - fi.pad_start[:-1]) // 128)[fi.processed]


def _plain(fi, p: Params) -> np.ndarray:
    return tiled_fit(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
        fi.gates, fi.consts[0], p,
    ).numpy()


@pytest.fixture(scope="module")
def jax_tiled_fit():
    """jit-compiled JAX tiled_fit per num_iter (one compile per config)."""
    cache = {}

    def get(num_iter: int):
        if num_iter not in cache:
            jp = JParams(num_iter=num_iter)
            tp = Params(num_iter=num_iter)
            tables = build_static_tables(tp, CZMGeometry.create(tp))
            cache[num_iter] = jax.jit(
                lambda xs, ys, zs, v, tpc, g, m: j_tiled_fit(
                    xs, ys, zs, v, tpc, g, m, params=jp,
                    num_zone0_patches=tables.num_zone0, comm=FrameComm(),
                    spad=g.shape[0],
                )
            )
        return cache[num_iter]

    return get


def _run_jax(fn, fi) -> np.ndarray:
    a = [t.numpy() for t in (fi.xs, fi.ys, fi.zs, fi.valid_f)]
    return np.asarray(fn(
        *a, fi.tile_patch.numpy()[:, None], fi.gates.numpy(),
        fi.consts[0].numpy(),
    ))


def _without_svals(t: np.ndarray, p: Params) -> np.ndarray:
    """A table without the port's eigenvalue columns (carry2 + 4 .. + 7),
    which the JAX package's table leaves zero or lacks."""
    sv = out_layout(p)[1] + 4
    return np.delete(t, [c for c in range(sv, sv + 3) if c < t.shape[1]], axis=1)


def _compare(ref: np.ndarray, out: np.ndarray, p: Params, rows=None, label=""):
    """Integer columns equal, float columns within ATOL + RTOL * |ref|;
    the port's eigenvalue columns are left out (``_without_svals``)."""
    snap_off, carry2_off, _ = out_layout(p)
    if rows is not None:
        ref, out = ref[rows], out[rows]
    ref, out = _without_svals(ref, p), _without_svals(out, p)
    int_cols = [OUT_N, OUT_GCOUNT] + list(range(snap_off, carry2_off, 5))
    np.testing.assert_array_equal(out[:, int_cols], ref[:, int_cols],
                                  err_msg=f"{label} integer columns")
    # A one-point fit's covariance divides by n - 1 = 0: the fused numerator
    # leaves a residual and gives +-inf (or 0/0 = NaN), in XLA:CPU and in
    # the port alike, and both make the sentinel plane
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin, err_msg=f"{label} non-finite")
    np.testing.assert_array_equal(out[~fin], ref[~fin], err_msg=f"{label} non-finite")
    ref64 = np.where(fin, ref, 0.0).astype(np.float64)
    err = np.abs(np.where(fin, out, 0.0).astype(np.float64) - ref64)
    print(f"{label}: max |err| {err.max():.3e} (column {int(err.max(0).argmax())}), "
          f"rows differing {int((err > 0).any(1).sum())} of {len(ref)}")
    np.testing.assert_array_less(err, ATOL + RTOL * np.abs(ref64),
                                 err_msg=f"{label} float columns")


def test_rne_split3_bitwise_equal_to_jax():
    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.normal(size=4096) * np.exp(rng.uniform(-60, 60, 4096)),
        [0.0, -0.0, 1.0, -1.0, 1e30, -1e30, 1.0039063, -1.0039063],
    ]).astype(np.float32)
    jparts = [np.asarray(x, np.float32) for x in jax.jit(j_split3)(jnp.asarray(v))]
    tparts = [x.numpy() for x in _rne_bf16_split3(torch.from_numpy(v))]
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(tp.view(np.int32), jp.view(np.int32))


def test_reduce_tiles_split3_selection_and_order():
    """A one-tile patch gets its tile sum back bit for bit; a many-tile
    patch gets the per-part f32 sums re-added as (hi + mid) + lo."""
    rng = np.random.default_rng(5)
    nt, c = 96, 10
    v = (rng.normal(size=(nt, c)) * np.exp(rng.uniform(-20, 20, (nt, c)))).astype(np.float32)
    # patches 0..47 own one tile each, patch 48 the remaining 48, 49 none
    pad_start = torch.tensor(list(range(0, 49 * 128, 128)) + [nt * 128, nt * 128],
                             dtype=torch.int32)
    idx, ok = tile_ranges(pad_start, nt)
    out = _reduce_tiles_split3(torch.from_numpy(v), idx, ok).numpy()
    np.testing.assert_array_equal(out[:48].view(np.int32), v[:48].view(np.int32))
    parts = [x.numpy() for x in _rne_bf16_split3(torch.from_numpy(v[48:]))]
    acc = [np.zeros(c, np.float32) for _ in range(3)]
    for t in range(48):
        for k in range(3):
            acc[k] = acc[k] + parts[k][t]
    np.testing.assert_array_equal(out[48], (acc[0] + acc[1]) + acc[2])
    assert (out[49] == 0).all()


@pytest.mark.parametrize(
    "kw", [{}, {"num_iter": 1}, {"num_iter": 4}, {"num_iter": 6},
           {"enable_RVPF": False}, {"th_seeds_v": 0.3, "th_dist": 0.2}],
)
def test_pass_program_and_layout_match_jax(kw):
    from patchworkpp_tpu.ops.pallas.fit_kernel_grid import _pass_config as j_pc

    jc, tc = j_pc(JParams(**kw)), fkg._pass_config(Params(**kw))
    assert jc[0] == tc[0]
    for a, b in zip(jc[1:], tc[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the same offsets; an extended table holds the 3 eigenvalue columns
    # past the JAX package's last column, the canonical one inside its 48
    js, jc2, jcols = j_out_layout(JParams(**kw))
    ts, tc2, tcols = out_layout(Params(**kw))
    assert (js, jc2) == (ts, tc2)
    assert tcols == (jcols if jcols == OUT_COLS else jcols + 3)


@pytest.mark.parametrize("seed", range(5))
def test_plain_fit_matches_jax_tiled_fit(jax_tiled_fit, seed):
    p = Params()
    fi = _fit_inputs(seed, p)
    out = _plain(fi, p)
    _compare(_run_jax(jax_tiled_fit(3), fi), out, p, label=f"seed {seed}")
    # the eigenvalue columns: the final covariance's, as the JAX package's
    # tail computes them (tests/test_torch_eigen.py holds these bits)
    cov = torch.from_numpy(np.ascontiguousarray(out[:, OUT_COV:OUT_COV + 6]))
    want = torch.stack(eig3_plane_columns(*cov.unbind(1), vector=False), dim=1).numpy()
    np.testing.assert_array_equal(out[:, OUT_SVALS:OUT_SVALS + 3], want)


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_fit_num_iter4_matches_jax_tiled_fit(jax_tiled_fit, seed):
    """num_iter=4 holds four R-VPF snapshots and moves carry2 behind them
    (out_layout)."""
    p = Params(num_iter=4)
    fi = _fit_inputs(seed, p)
    out = _plain(fi, p)
    assert out_layout(p)[1:] == (16 + 5 * 4, 16 + 5 * 4 + 7) == (36, out.shape[1])
    _compare(_run_jax(jax_tiled_fit(4), fi), out, p, label=f"num_iter=4 seed {seed}")


@pytest.mark.parametrize("cloud", ["crowded", "one_tile"])
def test_plain_fit_matches_jax_on_kernel_branch_clouds(jax_tiled_fit, cloud):
    """io/synthetic.py's crowded-patch cloud (one patch longer than the
    kernel's shared-memory cap) and one-tile cloud (every processed patch
    one tile), at capacity 131072."""
    p = Params()
    make = {"crowded": make_crowded_scan, "one_tile": make_one_tile_scan}[cloud]
    fi = _cloud_fit_inputs(make(0), p, CAPACITY)
    tiles = _processed_tiles(fi)
    if cloud == "crowded":
        assert int(tiles.max()) > fkg.CAP_TILES
    else:
        assert int(tiles.max()) == 1 and len(tiles) > 400
    _compare(_run_jax(jax_tiled_fit(3), fi), _plain(fi, p), p, label=cloud)


def test_plain_fit_on_64_beam_scan_matches_jax(jax_tiled_fit):
    """io/synthetic.py's 64-beam scan at capacity 131072: integer columns
    equal, and few float entries beyond 5e-5. Those left are clustered
    pairs' normals (their 1/sqrt, tests/test_torch_eigen.py) and the plane
    offsets d they move, 30 m from the sensor; 116 of them on an AVX-512
    host, whose reciprocal square-root estimate they depend on."""
    p = Params()
    fi = _cloud_fit_inputs(make_scan(0), p, CAPACITY)
    ref, out = _run_jax(jax_tiled_fit(3), fi), _plain(fi, p)
    rows = fi.counts.numpy() > 0  # the frame masks the rest (pipeline.py)
    ref, out = _without_svals(ref[rows], p), _without_svals(out[rows], p)
    snap_off, carry2_off, _ = out_layout(p)
    int_cols = [OUT_N, OUT_GCOUNT] + list(range(snap_off, carry2_off, 5))
    np.testing.assert_array_equal(out[:, int_cols], ref[:, int_cols])
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    err = np.abs(np.nan_to_num(out.astype(np.float64) - ref))
    beyond = int((err > ATOL).sum())
    print(f"64-beam scan: {beyond} entries beyond {ATOL}, "
          f"{int((err > 0).any(1).sum())} of {len(ref)} rows differ, max {err.max():.3e}")
    assert beyond < 250


def _extern_c_argtypes(source):
    """ctypes types of the ``extern "C"`` entry point's parameters, in
    order: c_void_p for a pointer, c_int for int, c_float for float."""
    m = re.search(r'extern "C" int \w+\(([^)]*)\)', source.read_text())
    assert m, source
    out = []
    for param in m.group(1).split(","):
        ctype = re.sub(r"\w+$", "", param.strip()).strip()  # drop the name
        if ctype.endswith("*"):
            out.append(ctypes.c_void_p)
        elif ctype == "int":
            out.append(ctypes.c_int)
        elif ctype == "float":
            out.append(ctypes.c_float)
        else:
            raise AssertionError(f"{source.name}: no ctypes rule for {param!r}")
    return out


@pytest.mark.parametrize("module", [fkg, fk], ids=["fit_grid", "fit_onehot"])
def test_ctypes_argtypes_follow_extern_c_signature(module):
    want = _extern_c_argtypes(module.SOURCE)
    assert len(want) > 15
    assert list(module.ARGTYPES) == want


def test_cap_tiles_is_the_kernel_constant():
    src = (fkg.SOURCE.parent / "fit_program.cuh").read_text()
    m = re.search(r"constexpr int kCapTiles = (\d+);", src)
    assert m and int(m.group(1)) == fkg.CAP_TILES
    for module in (fkg, fk):  # both kernels are the program of that header
        assert '#include "fit_program.cuh"' in module.SOURCE.read_text()


def test_plain_fit_matches_grid_kernel_interpret():
    """The Pallas grid kernel (interpret mode) leaves its pad column and
    the rows of unprocessed patches unspecified (the frame never reads
    them); every processed patch's row must agree."""
    p = Params()
    fi = _fit_inputs(0, p, exact_edges=True)
    gates = jnp.asarray(fi.gates.numpy())
    tpc = jnp.asarray(fi.tile_patch.numpy())
    grid = np.array(j_fkg.fused_fit_grid(
        *(jnp.asarray(t.numpy()) for t in (fi.xs, fi.ys, fi.zs, fi.valid_f)),
        tpc[:, None], j_patch_lookup(gates, tpc), gates,
        jnp.asarray(fi.consts.numpy())[None, :], params=JParams(),
        num_zone0_patches=build_static_tables(p, CZMGeometry.create(p)).num_zone0,
        interpret=True,
    ))
    grid[:, PAD_COL] = 0.0
    plain = _plain(fi, p)
    rows = fi.processed.numpy()
    assert rows.sum() > 20
    _compare(grid, plain, p, rows=rows, label="grid interpret")
    assert (plain[~rows] == 0).all()


def test_wrapper_runs_plain_on_cpu_without_counting():
    p = Params()
    fi = _fit_inputs(1, p)
    before = fkg.fused_fit_grid.launches
    out = fkg.fused_fit_grid(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch,
                             fi.pad_start, fi.gates, fi.consts, p)
    assert fkg.fused_fit_grid.launches == before
    np.testing.assert_array_equal(out.numpy(), _plain(fi, p))


def test_wrapper_refuses_other_devices():
    p = Params()
    t = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fkg.fused_fit_grid(t, t, t, t, torch.zeros(4, dtype=torch.int32, device="meta"),
                           torch.zeros(513, dtype=torch.int32, device="meta"),
                           torch.zeros((512, 8), device="meta"),
                           torch.zeros(8, device="meta"), p)


@pytest.mark.gpu
@pytest.mark.parametrize("num_iter,cloud", [(3, "seed2"), (4, "seed2"), (3, "crowded")])
def test_cuda_kernel_matches_plain_on_card(num_iter, cloud):
    """Kernel vs plain version on the same CUDA tensors: the same float
    operations in the same order (contraction off), so bit for bit; the
    crowded cloud's longest patch is staged chunk by chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = Params(num_iter=num_iter)
    if cloud == "crowded":
        fi = _cloud_fit_inputs(make_crowded_scan(0), p, CAPACITY)
        assert int(_processed_tiles(fi).max()) > fkg.CAP_TILES
    else:
        fi = _fit_inputs(2, p)
    dev = torch.device("cuda")
    a = [t.to(dev) for t in (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch,
                             fi.pad_start, fi.gates, fi.consts)]
    before = fkg.fused_fit_grid.launches
    k = fkg.fused_fit_grid(*a, p)
    torch.cuda.synchronize()
    assert fkg.fused_fit_grid.launches == before + 1
    plain = tiled_fit(*a[:7], a[7][0], p)
    np.testing.assert_array_equal(k.cpu().numpy(), plain.cpu().numpy())
