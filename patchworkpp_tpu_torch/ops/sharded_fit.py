"""The sharded fit kernel KS: the fit program of a frame whose points are
sharded (``parallel/``: chunked, point-sharded, shard x chunk), meeting the
other shards where the program needs their sums.

No TPU kernel is replaced: the JAX package's sharded fit is
``patchworkpp_tpu/ops/tiled_fit.py:tiled_fit`` with a comm, composed by
XLA. Its plain version here is ``ops/tiled_fit.py:tiled_fit(comm=...)``,
which the frame runs on the CPU. The source is ``csrc/fit_sharded.cu`` (the
fit program of ``csrc/fit_program.cuh`` with K1's per-patch sums), built by
``ops/nvcc.py`` at the first call. The shards meet twice a pass at most:
after a SEEDFIT pass's seed walk their dense LPR candidate tables are
merged (``MeshComm.merge_lpr_table``), after every pass's moment walk their
moment sums are added up (``reduce_patches``).

:func:`sharded_fit` takes one of two routes, by :func:`cluster_route`:

- the cluster route, where the comm's ``meet_local`` hook takes it (every
  shard a chunk of this process, at most ``MAX_CLUSTER``): the chunk
  threads meet once to hand over their fit inputs, and the last one
  launches :func:`cluster_fit`, one launch a frame for all of them, a
  thread-block cluster a patch whose CTAs merge and add in distributed
  shared memory in the comm's order;
- the phase route, for shards in other processes: the program cut where the
  shards meet. Each SEEDFIT pass launches a seed phase, which writes the
  shard's LPR table, and the comm merges the tables; every pass launches a
  moment phase, which writes the shard's moment sums, and the comm adds
  them up; one finish phase ends the frame. Each launch first ends the
  previous pass from its reduced sums. At default ``Params()`` (4 SEEDFIT
  and 3 FITDIST passes) a shard makes 4 x 2 + 3 + 1 = 12 launches a frame.
  The comm's arithmetic stays in PyTorch: it is the transport's.

Beside each phase launch is its plain counterpart (``_seed_reference``,
``_moments_reference``, ``_finish_reference``): the same slices of
``tiled_fit``'s loop (``tiled_fit.FitProgram``) on the same carried state.
``sharded_fit_reference`` runs the phase loop with them over the comm's
merge (one sorted concatenation of the shards' LPR rows) and reduction
(left-to-right sums): the plain version of both routes, which compute the
same function (the cluster kernel ranks the K rows' values where the comm
sorts them; the same values come out in the same order). It is for the
tests, which hold it to ``tiled_fit(comm=...)`` bit for bit
(``chip_smoke.py`` holds each route to both on the card). Where a pass's
gate is shut the kernel takes no LPR or moment sums and writes zeros; the
plain phases write the same zeros (the plain program's values there reach
no output).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from patchworkpp_tpu_torch.ops import f32, nvcc
from patchworkpp_tpu_torch.ops.fit_kernel_grid import (
    K_FITDIST,
    K_SEEDFIT,
    LANE,
    _pass_config,
    _program,
)
from patchworkpp_tpu_torch.ops.tiled_fit import FitProgram, out_layout
from patchworkpp_tpu_torch.params import Params

SOURCE = nvcc.CSRC / "fit_sharded.cu"
PHASE_SEED, PHASE_MOMENTS, PHASE_FINISH = 0, 1, 2
# kMaxLpr, kStateCols and kMaxChunks (the portable cluster size) of the source
MAX_LPR = 64
STATE_COLS = 16
MAX_CLUSTER = 8
MOM_COLS = 10

_ptr, _i32, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ppk_fit_sharded's parameters, in order
ARGTYPES = (
    _i32, _i32,                                      # phase pass
    _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,  # xs ys zs valid pad gates consts prog
    _i32,                                            # npasses
    _ptr, _ptr, _ptr,                                # mask state out
    _ptr, _ptr, _ptr, _ptr,                          # mom_in lpr_sum lpr_cnt tab
    _i32, _i32, _i32, _i32, _i32, _i32,              # nt spad out_cols snap carry2 num_lpr
    _flt, _flt,                                      # th_dist_v uprightness_thr
    _ptr,                                            # stream
)
# ppk_fit_sharded_cluster's parameters, in order
CLUSTER_ARGTYPES = (
    _i32, _ptr, _ptr,                     # nk chunk_ptrs chunk_nt
    _ptr, _ptr, _ptr, _i32,               # gates consts prog npasses
    _i32, _i32, _i32, _i32, _i32,         # spad out_cols snap carry2 num_lpr
    _flt, _flt,                           # th_dist_v uprightness_thr
    _ptr,                                 # stream
)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/fit_sharded.cu (once per source content) and load it,
    with its entry points declared."""
    lib = nvcc.build(SOURCE, "ppk_fit_sharded", ARGTYPES)
    lib.ppk_fit_sharded_cluster.argtypes = list(CLUSTER_ARGTYPES)
    lib.ppk_fit_sharded_cluster.restype = ctypes.c_int
    lib.ppk_fit_sharded_cluster_occupancy.argtypes = [_i32]
    lib.ppk_fit_sharded_cluster_occupancy.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


def launches_per_frame(params: Params) -> int:
    """The phase route's launches a shard a frame: two a SEEDFIT pass, one
    a FITDIST pass, one to finish (12 at default Params). The cluster route
    makes one a frame for all the chunks together."""
    npasses, kind = _pass_config(params)[:2]
    return npasses + int((kind == K_SEEDFIT).sum()) + 1


def cluster_route(args, params: Params, comm):
    """KS's cluster route, where ``comm`` takes it: ``comm.meet_local``
    hands every shard's fit inputs ``args`` to one :func:`cluster_fit`, and
    this shard's table comes back. It does so where all the shards are
    chunks of this process and at most ``MAX_CLUSTER`` (a thread-block
    cluster's portable size): ``PatchworkPP(chunks=K)``,
    ``make_chunked_frame_fn``, ``make_chunked_sequence_fn``. Returns None
    elsewhere (point-sharded over a process group, shard x chunk, more
    chunks), where the shards cross processes between the phases: those
    take the phase route, ``launches_per_frame`` launches a shard with the
    comm between them."""
    return comm.meet_local(args, lambda chunks: cluster_fit(chunks, params), MAX_CLUSTER)


def _drive(phases, params: Params, comm):
    """The sharded fit program: the phases in pass order with the comm's
    merge and reduction between them."""
    npasses, kind = _pass_config(params)[:2]
    lpr = params.num_lpr
    mom = None
    for i in range(npasses):
        lpr_sum = cnt = None
        if kind[i] == K_SEEDFIT:
            loc = phases.seed(i, mom)
            lpr_sum, cnt = comm.merge_lpr_table(
                loc[:, :lpr], loc[:, lpr:2 * lpr], loc[:, 2 * lpr], lpr)
        mom = comm.reduce_patches(phases.moments(i, mom, lpr_sum, cnt))
    return phases.finish(mom)


class _Kernel:
    """KS's launches on one shard's tiles, with the state they carry."""

    def __init__(self, xs, ys, zs, valid_f, pad_start, gates, consts, params: Params):
        dev = xs.device
        nt, spad = _check_chunk(xs, ys, zs, valid_f, pad_start, gates, consts, dev)
        _check_lpr(params)
        self.entry = build().ppk_fit_sharded
        self.params = params
        self.inputs = (xs, ys, zs, valid_f, pad_start, gates, consts)
        self.prog = _program(params, dev)
        self.snap_off, self.carry2_off, self.out_cols = out_layout(params)
        self.dims = (nt, spad)
        # carried across the frame's launches (each CTA writes its own rows
        # before it reads them)
        self.mask = torch.empty((nt, 4), dtype=torch.int32, device=dev)
        self.state = torch.empty((spad, STATE_COLS), dtype=torch.float32, device=dev)
        self.out = torch.empty((spad, self.out_cols), dtype=torch.float32, device=dev)
        self.loc = torch.empty((spad, 2 * params.num_lpr + 1), dtype=torch.float32,
                               device=dev)
        self.mom = torch.empty((spad, MOM_COLS), dtype=torch.float32, device=dev)

    def _checked(self, name, t, cols):
        if t is None:
            return None
        spad = self.dims[1]
        t = t.contiguous()
        nvcc.check(name, t, torch.float32, (spad, cols) if cols else (spad,),
                   self.out.device)
        return t

    def _launch(self, phase, i, mom=None, lpr_sum=None, cnt=None, tab=None):
        p = self.params
        nt, spad = self.dims
        mom = self._checked("reduced moments", mom, MOM_COLS)
        lpr_sum = self._checked("merged LPR sum", lpr_sum, 0)
        cnt = self._checked("merged LPR count", cnt, 0)
        stream = torch.cuda.current_stream(self.out.device).cuda_stream
        rc = self.entry(
            phase, i, *(t.data_ptr() for t in self.inputs), self.prog.data_ptr(),
            self.prog.shape[1], self.mask.data_ptr(), self.state.data_ptr(),
            self.out.data_ptr(), *(0 if t is None else t.data_ptr()
                                   for t in (mom, lpr_sum, cnt, tab)),
            nt, spad, self.out_cols, self.snap_off, self.carry2_off, p.num_lpr,
            f32(p.th_dist_v), f32(p.uprightness_thr), stream,
        )
        if rc != 0:
            raise RuntimeError(f"fit kernel KS launch failed (phase {phase}, pass {i}): "
                               f"CUDA error {rc}")
        sharded_fit.launches += 1

    def seed(self, i, mom):
        self._launch(PHASE_SEED, i, mom=mom, tab=self.loc)
        return self.loc

    def moments(self, i, mom, lpr_sum, cnt):
        self._launch(PHASE_MOMENTS, i, mom=mom, lpr_sum=lpr_sum, cnt=cnt, tab=self.mom)
        return self.mom

    def finish(self, mom):
        self._launch(PHASE_FINISH, _pass_config(self.params)[0], mom=mom)
        return self.out


def _check_chunk(xs, ys, zs, valid_f, pad_start, gates, consts, dev, spad=None):
    nt = xs.shape[0]
    spad = gates.shape[0] if spad is None else spad
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs), ("valid_f", valid_f)):
        nvcc.check(name, t, torch.float32, (nt, LANE), dev)
    nvcc.check("pad_start", pad_start, torch.int32, (spad + 1,), dev)
    nvcc.check("gates", gates, torch.float32, (spad, 8), dev)
    nvcc.check("consts", consts, torch.float32, (8,), dev)
    for name, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        if t.data_ptr() % 16:  # the row copy's float4 loads
            raise ValueError(f"{name} must be 16-byte aligned")
    return nt, spad


def _check_lpr(params: Params) -> None:
    if not 0 <= params.num_lpr <= MAX_LPR:
        raise ValueError(f"num_lpr={params.num_lpr}: the sharded fit kernel holds "
                         f"at most {MAX_LPR} LPR slots")


def cluster_fit(chunks, params: Params) -> list:
    """KS's cluster route: the fit tables of K (1..``MAX_CLUSTER``) chunks
    of one frame in one launch on the current stream, counted once in
    ``sharded_fit.launches``.

    ``chunks``: per chunk, ``(xs, ys, zs, valid_f, tile_patch, pad_start,
    gates_p, consts)`` as :func:`sharded_fit` takes them, all on one CUDA
    device. The kernel reads chunk 0's gates and consts (each chunk's come
    from the counts reduced over the chunks, so they hold the same values).
    Returns each chunk's (S, out_cols) table, equal bit for bit to the
    phase route's and to ``tiled_fit(comm=...)``. Raises on a tensor it
    cannot take, on a failed build or launch, and where no cluster of K
    CTAs fits on the card."""
    dev = chunks[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"the sharded fit kernel runs on CUDA tensors, not {dev}; "
                         "on the CPU the frame runs ops/tiled_fit.py:tiled_fit(comm=...)")
    return _launch_cluster(chunks, params)


def _launch_cluster(chunks, params: Params) -> list:
    """:func:`cluster_fit` past its device check: the input checks, the
    outputs and the launch."""
    k = len(chunks)
    if not 1 <= k <= MAX_CLUSTER:
        raise ValueError(f"the cluster route takes 1..{MAX_CLUSTER} chunks, not {k}")
    dev = chunks[0][0].device
    _check_lpr(params)
    spad = chunks[0][6].shape[0]
    ptrs, nts, outs = [], [], []
    snap_off, carry2_off, out_cols = out_layout(params)
    for xs, ys, zs, valid_f, _, pad_start, gates, consts in chunks:
        nt, _ = _check_chunk(xs, ys, zs, valid_f, pad_start, gates, consts, dev, spad)
        mask = torch.empty((nt, 4), dtype=torch.int32, device=dev)
        out = torch.empty((spad, out_cols), dtype=torch.float32, device=dev)
        ptrs += [t.data_ptr() for t in (xs, ys, zs, valid_f, pad_start, mask, out)]
        nts.append(nt)
        outs.append((mask, out))
    entry = build().ppk_fit_sharded_cluster
    prog = _program(params, dev)
    gates, consts = chunks[0][6], chunks[0][7]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_nts = (ctypes.c_int * k)(*nts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(k, ctypes.cast(c_ptrs, ctypes.c_void_p), ctypes.cast(c_nts, ctypes.c_void_p),
               gates.data_ptr(), consts.data_ptr(), prog.data_ptr(), prog.shape[1], spad,
               out_cols, snap_off, carry2_off, params.num_lpr, f32(params.th_dist_v),
               f32(params.uprightness_thr), stream)
    if rc == -1:
        raise RuntimeError(f"fit kernel KS: no cluster of {k} CTAs at its shared memory "
                           "fits on this card")
    if rc != 0:
        raise RuntimeError(f"fit kernel KS cluster launch failed ({k} chunks): "
                           f"CUDA error {rc}")
    sharded_fit.launches += 1
    return [out for _, out in outs]


def cluster_occupancy(k: int) -> int:
    """The most clusters of ``k`` CTAs of the cluster route that the current
    card holds at once (``cudaOccupancyMaxActiveClusters`` at the kernel's
    shared memory; 0 where none fits, and :func:`cluster_fit` then raises)."""
    n = build().ppk_fit_sharded_cluster_occupancy(k)
    if n < 0:
        raise RuntimeError(f"fit kernel KS: occupancy of {k}-CTA clusters: CUDA error {-n}")
    return n


def sharded_fit(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, consts, params: Params, comm,
):
    """One shard's per-patch fit table under a sharded comm, on the card.

    Args as :func:`~patchworkpp_tpu_torch.ops.fit_kernel_grid.fused_fit_grid`,
    on this shard's tiles (``gates_p`` from the counts reduced over the
    shards, so every shard gates alike), and ``comm``, the sharded
    ``pipeline.FrameComm`` that every shard's call meets through.
    ``tile_patch`` is read by the plain version only.

    The route follows :func:`cluster_route`: on the cluster route the
    chunks meet once (the comm's ``meet_local``) and the last one launches
    :func:`cluster_fit` for all of them; on the phase route this shard
    makes its :func:`launches_per_frame` launches with the comm's merge and
    reduction between them. Both are KS, from the same source.

    Returns the (S, out_cols) table of ``tiled_fit(..., comm=comm)``, bit for
    bit. Launches on the current stream (each launch counted in
    ``sharded_fit.launches``); raises on a tensor that is not on a CUDA
    device (the frame runs the plain ``tiled_fit`` on the CPU) and on a
    failed build or launch.
    """
    if xs.device.type != "cuda":
        raise ValueError(f"the sharded fit kernel runs on CUDA tensors, not {xs.device}; "
                         "on the CPU the frame runs ops/tiled_fit.py:tiled_fit(comm=...)")
    if not comm.is_sharded:
        raise ValueError("sharded_fit needs a sharded comm; the identity comm runs K1")
    table = cluster_route((xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, consts),
                          params, comm)
    if table is not None:
        return table
    return _drive(_Kernel(xs, ys, zs, valid_f, pad_start, gates_p, consts, params),
                  params, comm)


# Launches of the CUDA kernel (plain-version calls do not count).
sharded_fit.launches = 0


def _takes_lpr(prog: FitProgram, i: int) -> torch.Tensor:
    """(S, 1) the patches whose pass i takes an LPR table (gate open)."""
    return (prog.gate(i) > 0.5)[:, None]


def _takes_moments(prog: FitProgram, i: int) -> torch.Tensor:
    """(S, 1) the patches whose pass i takes moment sums: gate open, or a
    processed patch's final FITDIST (its g_count)."""
    final = bool(prog.kind[i] == K_FITDIST and prog.final[i])
    return ((prog.gate(i) > 0.5) | ((prog.proc_p > 0.5) & final))[:, None]


def _seed_reference(prog: FitProgram, i: int, mom) -> torch.Tensor:
    """The seed phase, plain: end pass i - 1, peel, the LPR table."""
    if i > 0:
        prog.end_pass(i - 1, mom)
    prog.peel(i)
    loc = prog.lpr_table(*prog.lpr_take())
    return torch.where(_takes_lpr(prog, i), loc, prog.zero)


def _moments_reference(prog: FitProgram, i: int, mom, lpr_sum, cnt) -> torch.Tensor:
    """The moment phase, plain: a FITDIST pass ends pass i - 1 first."""
    if prog.kind[i] == K_SEEDFIT:
        mask = prog.seed_mask(i, lpr_sum, cnt)
    else:
        prog.end_pass(i - 1, mom)
        mask = prog.dist_mask(i)
    return torch.where(_takes_moments(prog, i), prog.moments(mask), prog.zero)


def _finish_reference(prog: FitProgram, mom) -> torch.Tensor:
    """The finish phase, plain: end the last pass, the table."""
    prog.end_pass(prog.npasses - 1, mom)
    return prog.table()


class _Reference:
    def __init__(self, prog: FitProgram):
        self.prog = prog

    def seed(self, i, mom):
        return _seed_reference(self.prog, i, mom)

    def moments(self, i, mom, lpr_sum, cnt):
        return _moments_reference(self.prog, i, mom, lpr_sum, cnt)

    def finish(self, mom):
        return _finish_reference(self.prog, mom)


def sharded_fit_reference(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, consts, params: Params, comm,
):
    """The plain version of :func:`sharded_fit` on any device: the same phase
    loop over the plain phases (for the tests)."""
    prog = FitProgram(xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, consts[0],
                      params)
    return _drive(_Reference(prog), params, comm)
