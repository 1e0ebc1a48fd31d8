"""The sharded fit kernel KS's two routes (ops/sharded_fit.py), on the CPU.

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

The cluster route (one launch for the chunks of one process) computes the
same function, so its plain version is the same phase loop over the chunk
comm (the K chunks' plain phases, the comm's one sorted concatenation of
their LPR rows and its left-to-right sums). It is held to ``tiled_fit(
comm=...)`` bit for bit at K = 2, 4 and 8 too, on a cloud whose largest
patch holds more tiles in a chunk than the kernel keeps in shared memory,
and on clouds where a chunk holds none of a processed patch's rows; then
the route each comm takes, and the meeting's failure path.
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import patchworkpp_tpu.state as jstate
from patchworkpp_tpu.params import Params as JParams
from patchworkpp_tpu.parallel import make_chunked_frame_fn as j_chunked
from patchworkpp_tpu_torch import CZMGeometry, Params, init_state
from patchworkpp_tpu_torch import pipeline
from patchworkpp_tpu_torch.io.synthetic import make_crowded_scan, make_scan
from patchworkpp_tpu_torch.ops import nvcc
from patchworkpp_tpu_torch.ops import sharded_fit as sf
from patchworkpp_tpu_torch.ops.fit_kernel_grid import CAP_TILES
from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit
from patchworkpp_tpu_torch.parallel import make_chunked_frame_fn
from patchworkpp_tpu_torch.parallel.chunked import (
    ChunkComm,
    ChunkTransport,
    Exchange,
    _chunk_fit_tables,
    _chunk_wiring,
    run_chunks,
)
from patchworkpp_tpu_torch.parallel.point_sharded import GroupTransport, MeshComm
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
    if name == "crowded":  # a zone-0 patch of 18,000 points after ~32k others
        return make_crowded_scan(0, crowd=18000), 8 * CAP
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


def _tiles(fi, comm):
    """A chunk's tile count of each patch and which patches are processed."""
    return (fi.pad_start[1:] - fi.pad_start[:-1]) // 128, fi.gates[:, 0] > 0.5


@pytest.mark.parametrize("cloud", ["seed0", "seed1", "seed3"])
@pytest.mark.parametrize("num_chunks", [2, 4, 8])
def test_cluster_route_plain_equals_plain_sharded_fit(cloud, num_chunks):
    """The cluster route's plain version against tiled_fit(comm=...), every
    chunk's table bit for bit. The fuzz clouds fill under half the capacity,
    so the last chunks hold padding only, and dozens of processed patches
    have rows in one chunk and none in another."""
    p = Params()
    pts, cap = _cloud(cloud)
    outs = _chunk_fit_tables(p, num_chunks, _padded(pts, cap), len(pts),
                             [_reference(p), _plain(p), _tiles], device="cpu")
    for i, (cl, plain, _) in enumerate(outs):
        _assert_bitwise(cl, plain, f"{cloud} K={num_chunks} chunk {i}")
    tiles = torch.stack([t for _, _, (t, _) in outs])[:, outs[0][2][1]]
    assert ((tiles == 0).any(0) & (tiles > 0).any(0)).sum() > 20
    assert (outs[0][1][:, 7] > 0).sum() > 20


@pytest.mark.parametrize("num_chunks", [2, 4])
def test_cluster_route_plain_on_a_patch_longer_than_shared_memory(num_chunks):
    """A chunk holding more tiles of one patch than the kernel keeps in
    shared memory (its rows are staged chunk by chunk at every walk)."""
    p = Params()
    pts, cap = _cloud("crowded")
    outs = _chunk_fit_tables(p, num_chunks, _padded(pts, cap), len(pts),
                             [_reference(p), _plain(p), _tiles], device="cpu")
    for i, (cl, plain, _) in enumerate(outs):
        _assert_bitwise(cl, plain, f"crowded K={num_chunks} chunk {i}")
    longest = max(int(t[proc].max()) for _, _, (t, proc) in outs)
    assert longest > CAP_TILES


def test_route_choice(monkeypatch):
    """The chunks of one process, at most MAX_CLUSTER of them, take the
    cluster route: one cluster_fit call for all of them, each chunk handed
    its own table. A shard x chunk exchange (an outer group), a process
    group's ranks and more chunks take the phases: None, and no meeting."""
    calls = []

    def fake(chunks, params):
        calls.append(len(chunks))
        return [("table", c) for c in chunks]

    monkeypatch.setattr(sf, "cluster_fit", fake)
    p = Params()
    geom, cpu = CZMGeometry.create(p), torch.device("cpu")
    for k in (1, 2, 4, 8):
        ex, comms, _ = _chunk_wiring(p, geom, cpu, None, k)
        got = run_chunks(ex, [lambda i=i: sf.cluster_route(("args", i), p, comms[i])
                              for i in range(k)])
        assert got == [("table", ("args", i)) for i in range(k)]
    assert calls == [1, 2, 4, 8]

    class Outer:
        index = 0

    _, comms, _ = _chunk_wiring(p, geom, cpu, None, sf.MAX_CLUSTER + 1)
    assert sf.cluster_route(("args", 0), p, comms[0]) is None
    _, comms, _ = _chunk_wiring(p, geom, cpu, None, 2, Outer())
    assert isinstance(comms[0], ChunkComm)
    assert sf.cluster_route(("args", 0), p, comms[0]) is None
    assert sf.cluster_route(("args", 0), p, MeshComm(GroupTransport.__new__(GroupTransport))) \
        is None
    assert sf.cluster_route(("args", 0), p, pipeline.FrameComm()) is None
    assert calls == [1, 2, 4, 8]


def test_meeting_failure_ends_every_chunk():
    """A chunk whose meeting call raises (the last one runs it) ends the
    others; run_chunks raises that error, not the others' broken turns."""
    ex = Exchange(3)
    comms = [ChunkComm(ChunkTransport(ex, i)) for i in range(3)]

    def fail(objs):
        assert objs == [0, 1, 2]
        raise RuntimeError("launch refused")

    with pytest.raises(RuntimeError, match="launch refused"):
        run_chunks(ex, [lambda i=i: comms[i].meet_local(i, fail, 8) for i in range(3)])
    got = run_chunks(ex, [lambda i=i: comms[i].meet_local(
        i, lambda objs: [sum(objs) + j for j in range(3)], 8) for i in range(3)])
    assert got == [3, 4, 5]


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


def test_cluster_launch_failure_raises(monkeypatch):
    """The cluster launch raises on a CUDA error and where no cluster of K
    CTAs fits (the entry's -1), counts nothing, and falls back to nothing."""
    p = Params()
    fi, _ = _fit_inputs(p)
    chunk = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates, fi.consts)
    rcs = []

    class Lib:
        @staticmethod
        def ppk_fit_sharded_cluster(*args):
            rcs.append(args[0])
            return rc

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(sf, "build", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream)
    before = sf.sharded_fit.launches
    for rc, want in ((700, "CUDA error 700"), (-1, "no cluster of 2 CTAs")):
        with pytest.raises(RuntimeError, match=want):
            sf._launch_cluster([chunk, chunk], p)
    assert rcs == [2, 2]
    assert sf.sharded_fit.launches == before
    with pytest.raises(ValueError, match="1..8 chunks"):
        sf._launch_cluster([chunk] * (sf.MAX_CLUSTER + 1), p)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sf.cluster_fit([chunk, chunk], p)


def test_cluster_occupancy_reads_the_entry(monkeypatch):
    """The occupancy query returns the entry's cluster count and raises on
    the entry's negated CUDA error."""
    asked = []

    class Lib:
        @staticmethod
        def ppk_fit_sharded_cluster_occupancy(k):
            asked.append(k)
            return 16 if k == 4 else -98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setattr(sf, "build", lambda: Lib)
    assert sf.cluster_occupancy(4) == 16
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        sf.cluster_occupancy(8)
    assert asked == [4, 8]


def test_launches_per_frame_and_source_constants():
    assert sf.launches_per_frame(Params()) == 12  # 4 SEEDFIT x 2 + 3 FITDIST + 1
    assert sf.launches_per_frame(Params(num_iter=4)) == 15
    assert sf.launches_per_frame(Params(enable_RVPF=False)) == 6
    src = sf.SOURCE.read_text()
    for name, value in (("kMaxLpr", sf.MAX_LPR), ("kStateCols", sf.STATE_COLS),
                        ("kMaxChunks", sf.MAX_CLUSTER)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert '#include "fit_program.cuh"' in src
    want = _extern_c_argtypes(sf.SOURCE)
    assert list(sf.ARGTYPES) == want and ctypes.c_float in want
    want = _extern_c_argtypes(sf.SOURCE, "ppk_fit_sharded_cluster")
    assert list(sf.CLUSTER_ARGTYPES) == want
    assert _extern_c_argtypes(sf.SOURCE, "ppk_fit_sharded_cluster_occupancy") == [ctypes.c_int]
    assert src.count("cluster.sync()") >= 3  # the LPR row, the moment row, the exit


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["phases", "cluster"])
@pytest.mark.parametrize("num_chunks", [2, 4, 8])
def test_cuda_kernel_matches_plain_on_card(num_chunks, route):
    """KS vs tiled_fit(comm=...) and the route's plain version on the same
    CUDA tensors, bit for bit, with the route's launch count (the phases:
    their count a chunk; the cluster: one for all the chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    p = Params()
    pts, cap = _cloud("scan")

    def kernel(fi, comm):
        if route == "cluster":  # the route sharded_fit takes for these chunks
            return sf.sharded_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch,
                                  fi.pad_start, fi.gates, fi.consts, p, comm)
        return sf._drive(sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, fi.gates,
                                    fi.consts, p), p, comm)

    ref = _reference(p)
    before = sf.sharded_fit.launches
    outs = _chunk_fit_tables(p, num_chunks, _padded(pts, cap).cuda(), len(pts),
                             [kernel, _plain(p), ref], device="cuda")
    torch.cuda.synchronize()
    want = 1 if route == "cluster" else num_chunks * sf.launches_per_frame(p)
    assert sf.sharded_fit.launches - before == want
    for i, (k, plain, r) in enumerate(outs):
        _assert_bitwise(k.cpu(), plain.cpu(), f"{route} K={num_chunks} chunk {i}")
        _assert_bitwise(k.cpu(), r.cpu(), f"{route} K={num_chunks} chunk {i} (its plain)")
