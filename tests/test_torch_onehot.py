"""The unrolled fit kernel K2 (``fused="onehot"``): its plain version
(ops/fit_kernel.py:fused_fit_reference, the CPU path of the CUDA kernel
csrc/fit_onehot.cu) vs the JAX package's Pallas kernel ``fused_fit`` in
interpret mode, at capacity 8192.

Both sides get the SAME tiled inputs (built once by the port's frame from
``synth_cloud``), so the comparison isolates the fit program. Integer
columns (n, g_count, the R-VPF snapshot gates) must be equal. Float columns
agree to a few ulp, within atol 5e-5 + rtol 5e-5: the port adds the same
tile sums in tile order, but XLA:CPU sums a one-hot dot's terms in its own
order and a clustered pair's normal has its own 1/sqrt
(tests/test_torch_eigen.py); the largest difference seen is
3.0e-5, on an R-VPF snapshot plane offset d (seed 0). That is under a tenth
of the 0.125 m th_dist margin a label decision reads. Column 15, which the
Pallas kernel never writes, is compared as zero.

The test marked ``gpu`` holds the CUDA kernel against the plain version on
the card; it skips where there is no CUDA device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu.ops.pallas import fit_kernel as j_fk
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.pipeline import make_frame_fn as j_make_frame_fn
from patchworkpp_tpu_torch import CZMGeometry, Params
from patchworkpp_tpu_torch.ops import fit_kernel as fk
from patchworkpp_tpu_torch.ops.fit_kernel import OUT_COLS, fused_fit_reference
from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit
from patchworkpp_tpu_torch.pipeline import build_static_tables, make_frame_fn
from patchworkpp_tpu_torch.io.synthetic import CAPACITY, make_crowded_scan, make_one_tile_scan
from test_torch_fit import (  # noqa: F401
    PAD_COL,
    _cloud_fit_inputs,
    _compare,
    _fit_inputs,
    _one_torch_thread,
)

# a CZM whose patch space is not the kernels' 512 (632 patches, spad 640)
WIDE_CZM = {"num_sectors_each_zone": (16, 32, 54, 64)}


def _args(fi):
    return (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
            fi.gates, fi.consts)


def _jax_fused_fit(fi, p: Params) -> np.ndarray:
    nz0 = build_static_tables(p, CZMGeometry.create(p)).num_zone0
    out = np.array(j_fk.fused_fit(
        *(jnp.asarray(t.numpy()) for t in (fi.xs, fi.ys, fi.zs, fi.valid_f)),
        jnp.asarray(fi.tile_patch.numpy())[:, None], jnp.asarray(fi.gates.numpy()),
        jnp.asarray(fi.consts.numpy())[None, :], params=JParams(),
        num_zone0_patches=nz0, interpret=True,
    ))
    out[:, PAD_COL] = 0.0
    return out


@pytest.mark.parametrize("seed", range(3))
def test_plain_k2_matches_jax_fused_fit_interpret(seed):
    p = Params()
    fi = _fit_inputs(seed, p)
    plain = fused_fit_reference(*_args(fi), p).numpy()
    assert plain.shape == (512, OUT_COLS)
    _compare(_jax_fused_fit(fi, p), plain, p, label=f"K2 seed {seed}")
    # unprocessed patches hold an all-zero row, as in the TPU kernel
    assert (plain[~fi.processed.numpy()] == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_plain_k2_integer_columns_equal_k1(seed):
    """K2 and K1 run one program with other per-patch sums (plain f32 vs
    split bf16x3): integer columns equal, floats within the same class."""
    p = Params()
    fi = _fit_inputs(seed, p, exact_edges=True)
    k1 = tiled_fit(*_args(fi)[:7], fi.consts[0], p).numpy()
    _compare(k1, fused_fit_reference(*_args(fi), p).numpy(), p, label=f"K2 vs K1 seed {seed}")


@pytest.mark.parametrize("cloud", ["crowded", "one_tile"])
def test_plain_k2_integer_columns_equal_k1_on_kernel_branch_clouds(cloud):
    """io/synthetic.py's crowded-patch cloud (one patch staged chunk by chunk
    in the kernels) and one-tile cloud, at capacity 131072: K2's and K1's
    plain versions agree on every integer column."""
    p = Params()
    make = {"crowded": make_crowded_scan, "one_tile": make_one_tile_scan}[cloud]
    fi = _cloud_fit_inputs(make(0), p, CAPACITY)
    k1 = tiled_fit(*_args(fi)[:7], fi.consts[0], p).numpy()
    _compare(k1, fused_fit_reference(*_args(fi), p).numpy(), p, label=f"K2 vs K1 {cloud}")


@pytest.mark.parametrize("mode", ["onehot", "grid", "grid_iota", True])
@pytest.mark.parametrize("case", ["spad", "num_iter"])
def test_kernel_modes_refuse_what_the_tpu_layout_cannot_hold(mode, case):
    """The TPU kernels' output has 512 patch rows and 3 snapshot slots: the
    JAX package refuses spad != 512 and num_iter > 3 for these modes, and
    so does the port, with the same message."""
    kw = WIDE_CZM if case == "spad" else {"num_iter": 4}
    match = "spad=640" if case == "spad" else "num_iter=4"
    with pytest.raises(ValueError, match=match) as theirs:
        j_make_frame_fn(JParams(**kw), fused=mode)
    with pytest.raises(ValueError, match=match) as ours:
        make_frame_fn(Params(**kw), device="cpu", fused=mode)
    assert str(ours.value) == str(theirs.value)
    # the other engines take both
    make_frame_fn(Params(**kw), device="cpu", fused="tiled")
    make_frame_fn(Params(**kw), device="cpu", fused=False)


def test_plain_k2_refuses_four_snapshots():
    p = Params()
    fi = _fit_inputs(0, p)
    with pytest.raises(ValueError, match="num_iter=4"):
        fused_fit_reference(*_args(fi), Params(num_iter=4))


def test_wrapper_runs_plain_on_cpu_without_counting():
    p = Params()
    fi = _fit_inputs(1, p)
    before = fk.fused_fit.launches
    out = fk.fused_fit(*_args(fi), p)
    assert fk.fused_fit.launches == before
    np.testing.assert_array_equal(out.numpy(), fused_fit_reference(*_args(fi), p).numpy())


def test_wrapper_refuses_other_devices():
    t = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fk.fused_fit(t, t, t, t, torch.zeros(4, dtype=torch.int32, device="meta"),
                     torch.zeros(513, dtype=torch.int32, device="meta"),
                     torch.zeros((512, 8), device="meta"),
                     torch.zeros(8, device="meta"), Params())


@pytest.mark.gpu
def test_cuda_k2_matches_plain_on_card():
    """Kernel vs plain version on the same CUDA tensors: the same float
    operations in the same order (contraction off), so bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = Params()
    fi = _fit_inputs(2, p)
    a = [t.to("cuda") for t in _args(fi)]
    before = fk.fused_fit.launches
    k = fk.fused_fit(*a, p)
    torch.cuda.synchronize()
    assert fk.fused_fit.launches == before + 1
    np.testing.assert_array_equal(k.cpu().numpy(), fused_fit_reference(*a, p).cpu().numpy())
