"""The sharded fit kernel KS's phase split (ops/sharded_fit.py), on the CPU.

KS runs only on the card; here its plain phases (``sharded_fit_reference``:
the same phase loop, the same carried state, the same slices of the fit
program) are held to the composed plain program ``tiled_fit(comm=...)`` bit
for bit on every table entry, for the in-process chunk comm at K = 2 and 4,
on tests/test_fuzz_parity.py:synth_cloud seeds and on the 64-beam
io/synthetic.make_scan(0, 0)[::8]. That pins the pass order, the pending
plane update each launch applies first and the active rows carried across
launches before the card runs them (chip_smoke.py holds the kernel to both
on the card). Then the chunked frame fed by the phase loop's table against
the JAX package's chunked engine (labels, means and eigenvalues with
tolerance 0, the normals within tests/test_torch_chunked.py's tolerance),
and the wrapper's refusals: a CPU tensor, a failed build, a failed launch.
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.parallel import make_chunked_frame_fn as j_chunked
from patchworkpp_tpu_torch import Params, init_state
from patchworkpp_tpu_torch import pipeline
from patchworkpp_tpu_torch.io.synthetic import make_scan
from patchworkpp_tpu_torch.ops import nvcc
from patchworkpp_tpu_torch.ops import sharded_fit as sf
from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit
from patchworkpp_tpu_torch.parallel import make_chunked_frame_fn
from patchworkpp_tpu_torch.parallel.chunked import _chunk_fit_tables
from test_fuzz_parity import CAP, synth_cloud
from test_torch_chunked import _assert_tables_close
from test_torch_fit import _extern_c_argtypes
from test_torch_frame import _one_torch_thread  # noqa: F401


def _padded(cloud, capacity):
    pts = np.zeros((capacity, 4), np.float32)
    pts[: len(cloud)] = cloud
    return torch.from_numpy(pts)


def _cloud(name):
    if name == "scan":
        return make_scan(0, 0)[::8], 2 * CAP  # ~15k points
    return synth_cloud(int(name[-1]), exact_edges=False), CAP


def _reference(p):
    def fit(fi, comm):
        return sf.sharded_fit_reference(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch,
                                        fi.pad_start, fi.gates, fi.consts, p, comm)
    return fit


def _plain(p):
    def fit(fi, comm):
        return tiled_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                         fi.gates, fi.consts[0], p, comm=comm)
    return fit


def _assert_bitwise(a, b, label):
    a, b = a.numpy(), b.numpy()
    assert a.shape == b.shape, label
    diff = a.view(np.int32) != b.view(np.int32)
    assert not diff.any(), (f"{label}: {int(diff.any(1).sum())} rows differ, "
                            f"columns {np.nonzero(diff.any(0))[0].tolist()}")


@pytest.mark.parametrize("cloud", ["seed0", "seed1", "scan"])
@pytest.mark.parametrize("num_chunks", [2, 4])
def test_phase_loop_equals_plain_sharded_fit(cloud, num_chunks):
    p = Params()
    pts, cap = _cloud(cloud)
    outs = _chunk_fit_tables(p, num_chunks, _padded(pts, cap), len(pts),
                             [_reference(p), _plain(p)], device="cpu")
    assert len(outs) == num_chunks
    for i, (ref, plain) in enumerate(outs):
        _assert_bitwise(ref, plain, f"{cloud} K={num_chunks} chunk {i}")
    assert (outs[0][1][:, 7] > 0).sum() > 20  # processed patches with a fit


@pytest.mark.parametrize("kw", [{"num_iter": 4}, {"enable_RVPF": False}, {"num_lpr": 7}],
                         ids=["num_iter4", "no_rvpf", "num_lpr7"])
def test_phase_loop_equals_plain_on_other_programs(kw):
    """Other pass programs: more R-VPF rounds (a longer snapshot layout), no
    R-VPF (one SEEDFIT pass), fewer LPR slots."""
    p = Params(**kw)
    pts, cap = _cloud("seed2")
    for i, (ref, plain) in enumerate(_chunk_fit_tables(
            p, 2, _padded(pts, cap), len(pts), [_reference(p), _plain(p)], device="cpu")):
        _assert_bitwise(ref, plain, f"{kw} chunk {i}")


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_frame_on_phase_loop_matches_jax(monkeypatch, seed):
    """The chunked frame with its fit table from the phase loop: labels,
    patch means and eigenvalues equal to the JAX chunked engine's, the
    normals within the chunked tests' tolerance (a clustered pair's last bit
    follows the host's rsqrt in XLA:CPU), and every field equal to the plain
    chunked frame's."""
    p = Params()
    cloud = synth_cloud(seed, exact_edges=False)
    pts = _padded(cloud, CAP)
    _, want = make_chunked_frame_fn(p, 2, device="cpu")(init_state(p, device="cpu"), pts,
                                                        len(cloud))
    calls = []

    def driven(xs, ys, zs, valid_f, tile_patch, pad_start, gates, margin, params, comm):
        calls.append(1)
        return sf.sharded_fit_reference(xs, ys, zs, valid_f, tile_patch, pad_start, gates,
                                        margin.reshape(1), params, comm)

    monkeypatch.setattr(pipeline, "tiled_fit", driven)
    _, res = make_chunked_frame_fn(p, 2, device="cpu")(init_state(p, device="cpu"), pts,
                                                       len(cloud))
    assert len(calls) == 2  # one per chunk
    _, jres = j_chunked(JParams(), 2)(jstate.init_state(JParams()), jnp.asarray(pts.numpy()),
                                      jnp.int32(len(cloud)))
    np.testing.assert_array_equal(res.ground_mask.numpy(), np.asarray(jres.ground_mask))
    assert int(res.num_ground) == int(jres.num_ground) > 0
    for f in ("patch_mean", "patch_svals", "patch_processed"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                                      err_msg=f)
    _assert_tables_close(res, jres, f"seed {seed}")
    for f in res._fields:
        np.testing.assert_array_equal(getattr(res, f).numpy(), getattr(want, f).numpy(),
                                      err_msg=f)


def _fit_inputs(p):
    cloud = synth_cloud(0, exact_edges=False)
    got = _chunk_fit_tables(p, 2, _padded(cloud, CAP), len(cloud), [lambda fi, c: (fi, c)],
                            device="cpu")
    return got[0][0]


def test_sharded_fit_refuses_cpu_tensors():
    """On the CPU the frame runs the plain program itself; the wrapper never
    stands in for it."""
    p = Params()
    fi, comm = _fit_inputs(p)
    before = sf.sharded_fit.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        sf.sharded_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                       fi.gates, fi.consts, p, comm)
    assert sf.sharded_fit.launches == before


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "_nvcc", lambda source: "false")
    sf.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            sf.build()
    finally:
        sf.build.cache_clear()


def test_launch_failure_raises(monkeypatch):
    """A launch whose C entry returns a CUDA error raises, counts nothing
    and is not retried by anything else."""
    p = Params()
    fi, comm = _fit_inputs(p)
    calls = []

    class Lib:
        @staticmethod
        def ppk_fit_sharded(*args):
            calls.append(args[:2])
            return 700  # cudaErrorIllegalAddress

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(sf, "build", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    kernel = sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, fi.gates, fi.consts, p)
    before = sf.sharded_fit.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.seed(0, None)
    assert calls == [(sf.PHASE_SEED, 0)]
    assert sf.sharded_fit.launches == before


@pytest.mark.parametrize("case", ["num_lpr", "misaligned", "gates_shape"])
def test_kernel_checks_its_inputs(monkeypatch, case):
    """The wrapper refuses what the kernel's pointer arithmetic cannot take,
    before it builds or launches anything."""
    p = Params(num_lpr=sf.MAX_LPR + 1) if case == "num_lpr" else Params()
    fi, _ = _fit_inputs(Params())
    xs, gates = fi.xs, fi.gates
    if case == "misaligned":
        xs = torch.zeros(xs.numel() + 1)[1:].view(xs.shape)
    if case == "gates_shape":
        gates = gates[:, :7].contiguous()
    monkeypatch.setattr(sf, "build", lambda: pytest.fail("built before its checks"))
    want = {"num_lpr": "at most 64 LPR slots", "misaligned": "16-byte aligned",
            "gates_shape": "gates has shape"}[case]
    with pytest.raises(ValueError, match=want):
        sf._Kernel(xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, gates, fi.consts, p)


def test_launches_per_frame_and_source_constants():
    assert sf.launches_per_frame(Params()) == 12  # 4 SEEDFIT x 2 + 3 FITDIST + 1
    assert sf.launches_per_frame(Params(num_iter=4)) == 15
    assert sf.launches_per_frame(Params(enable_RVPF=False)) == 6
    src = sf.SOURCE.read_text()
    for name, value in (("kMaxLpr", sf.MAX_LPR), ("kStateCols", sf.STATE_COLS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert '#include "fit_program.cuh"' in src
    want = _extern_c_argtypes(sf.SOURCE)
    assert list(sf.ARGTYPES) == want and ctypes.c_float in want


@pytest.mark.gpu
@pytest.mark.parametrize("num_chunks", [2, 4])
def test_cuda_kernel_matches_plain_on_card(num_chunks):
    """KS vs tiled_fit(comm=...) on the same CUDA tensors, bit for bit, with
    the stated launch count a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = Params()
    pts, cap = _cloud("scan")

    def kernel(fi, comm):
        return sf.sharded_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                              fi.gates, fi.consts, p, comm)

    before = sf.sharded_fit.launches
    outs = _chunk_fit_tables(p, num_chunks, _padded(pts, cap).cuda(), len(pts),
                             [kernel, _plain(p)], device="cuda")
    torch.cuda.synchronize()
    assert sf.sharded_fit.launches - before == num_chunks * sf.launches_per_frame(p)
    for i, (k, plain) in enumerate(outs):
        _assert_bitwise(k.cpu(), plain.cpu(), f"K={num_chunks} chunk {i}")
