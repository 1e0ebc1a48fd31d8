"""The ground-segmentation frame step (port of ``patchworkpp_tpu/pipeline.py``;
reference estimateGround, cpp/patchworkpp/src/patchworkpp.cpp:151-336).

A frame is: sanitize -> RNR + CZM binning -> the R-VPF/R-GPF plane fits ->
eigenvalues -> A-GLE, TGR, the adaptive-state update, and the labels
replayed in original point order from small per-patch plane tables. The
fits run in one of two engines (``make_frame_fn(fused=...)``):

- fused (default): a (patch, z) sort into single-patch tiles, then the fit
  pass program as one kernel launch, K1 (ops/fit_kernel_grid.py) or the
  unrolled K2 (ops/fit_kernel.py:fused_fit); CUDA kernels on the card,
  their plain versions on the CPU;
- unfused (``fused=False``): the sorted layout and per-pass PyTorch ops
  (lookups, and fixed-order per-patch sums: the kernel KR,
  ops/patch_reduce_kernel.py, on the card), JAX ``pipeline.py:frame``.

Reductions whose order the backend would choose (the adaptive buffers'
mean and stdev, the per-patch heading, the per-patch moment sums) are
written in a fixed order, so that a frame gives the same bits on the CPU
and on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from patchworkpp_tpu_torch.ops import div, f32, fma, plane_dist, row_sums, seq_sum, sqrt
from patchworkpp_tpu_torch.ops.binning import bin_points, factored_patch_counts
from patchworkpp_tpu_torch.ops.eigen3 import eigh3x3_descending
from patchworkpp_tpu_torch.ops.fit_kernel import (
    OUT_D,
    OUT_GCOUNT,
    OUT_MEAN,
    OUT_N,
    OUT_NORMAL,
    check_onehot_limits,
    fused_fit,
)
from patchworkpp_tpu_torch.ops.fit_kernel_grid import fused_fit_grid
from patchworkpp_tpu_torch.ops.label_replay_kernel import label_replay
from patchworkpp_tpu_torch.ops.moments import moments_to_mean_cov
from patchworkpp_tpu_torch.ops.onehot import (
    patch_lookup,
    patch_lookup_cols,
    patch_moment_sums,
    patch_reduce,
)
from patchworkpp_tpu_torch.ops.segments import (
    SortedPoints,
    patch_counts,
    segment_rank,
    sort_by_patch,
)
from patchworkpp_tpu_torch.ops.sharded_fit import sharded_fit
from patchworkpp_tpu_torch.ops.tiled import TILE, build_tiled
from patchworkpp_tpu_torch.ops.tiled_fit import out_layout, tiled_fit
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.state import BUF_CAP, PLANE_WIDTH, AdaptiveState

_F32_MAX = float(np.finfo(np.float32).max)
_COORD_SANE = f32(1e9)  # meters; LiDAR returns are < a few hundred

# Row-block size of the original-order label replay's plain version
# (ops/label_replay_kernel.py:label_replay_reference, the CPU path): bounds
# the (rows, C) gathered label table it materializes. Module-level so tests
# can shrink it to exercise the multi-block path on small clouds.
_REPLAY_BLOCK = 65536


class FrameResult(NamedTuple):
    """Per-frame outputs (original point order)."""

    ground_mask: torch.Tensor      # (P,) bool; padding rows are False
    num_ground: torch.Tensor       # () int32
    # the reference's plane members after each patch: an empty processed
    # patch's are those it inherited (carry_planes), a 1-point fit's normal
    # and eigenvalues NaN
    patch_mean: torch.Tensor       # (NP, 3) final per-patch plane centroid
    patch_normal: torch.Tensor     # (NP, 3) final per-patch plane normal
    patch_svals: torch.Tensor      # (NP, 3) eigenvalues, descending
    patch_processed: torch.Tensor  # (NP,) bool: had >= num_min_pts points


class FitInputs(NamedTuple):
    """One frame's fit-kernel inputs and what the frame's tail reads."""

    xs: torch.Tensor          # (NT, 128) f32 tiled x
    ys: torch.Tensor          # (NT, 128) f32
    zs: torch.Tensor          # (NT, 128) f32
    valid_f: torch.Tensor     # (NT, 128) f32 1 = real point
    tile_patch: torch.Tensor  # (NT,) int32, sentinels clamped to S-1
    pad_start: torch.Tensor   # (S+1,) int32
    gates: torch.Tensor       # (S, 8) f32
    consts: torch.Tensor      # (8,) f32 [margin_thr, 0..]
    counts: torch.Tensor      # (S,) f32 points per patch
    processed: torch.Tensor   # (S,) bool
    points: torch.Tensor      # (P, 4) sanitized cloud, original order
    patch_id: torch.Tensor    # (P,) int32 patch of each point


class StaticTables(NamedTuple):
    """Host-precomputed per-patch constants over the spad-wide patch space."""

    zone: np.ndarray        # (S,) int32 zone of each patch
    cring: np.ndarray       # (S,) int32 concentric ring; pad -> num rings
    shift: np.ndarray       # (S, 3) f32 static centering offset per patch
    ring_slices: Tuple[Tuple[int, int], ...]  # (start, stop) per ring of interest
    max_ring_patches: int   # pad width for ring-of-interest arrays
    num_zone0: int          # patches in zone 0 (flat ids [0, num_zone0))


def build_static_tables(params: Params, geom: CZMGeometry) -> StaticTables:
    """Per-patch zone, concentric ring and centering shift (any CZM)."""
    p = params
    npz = geom.num_patches
    spad = geom.spad
    if npz > 65536:
        raise ValueError(
            f"CZM has {npz} patches; refusing configs past 65536"
        )
    zone = np.full(spad, p.num_zones - 1, np.int32)
    zone[:npz] = geom.patch_zone()
    cring = np.full(spad, geom.num_concentric_rings, np.int32)
    cring[:npz] = geom.patch_concentric_ring()

    # The patch's geometric center at the nominal ground height: keeps the
    # f32 covariance well conditioned; any fixed offset is neutral.
    shift = np.zeros((spad, 3), np.float32)
    sector = geom.patch_sector()
    lo = np.asarray(geom.min_ranges)
    for pid in range(npz):
        k = int(zone[pid])
        ring_in_zone = (pid - geom.zone_patch_offset[k]) // p.num_sectors_each_zone[k]
        r_mid = lo[k] + (ring_in_zone + 0.5) * geom.ring_sizes[k]
        th_mid = (sector[pid] + 0.5) * geom.sector_sizes[k]
        shift[pid] = [r_mid * np.cos(th_mid), r_mid * np.sin(th_mid), -p.sensor_height]

    ring_slices = []
    for ci in range(p.num_rings_of_interest):
        sel = np.flatnonzero(cring[:npz] == ci)
        ring_slices.append((int(sel[0]), int(sel[-1]) + 1))
    max_rp = max(b - a for a, b in ring_slices)
    return StaticTables(
        zone=zone,
        cring=cring,
        shift=shift,
        ring_slices=tuple(ring_slices),
        max_ring_patches=max_rp,
        num_zone0=p.num_rings_each_zone[0] * p.num_sectors_each_zone[0],
    )


class _PlaneCarry(NamedTuple):
    """Per-patch plane-fit state of the unfused engine, with the
    reference's staleness: an empty fit leaves the previous values in place
    (patchworkpp.cpp:49)."""

    n: torch.Tensor       # (S,) last successful fit's point count
    mean: torch.Tensor    # (S, 3)
    normal: torch.Tensor  # (S, 3)
    d: torch.Tensor       # (S,)
    svals: torch.Tensor   # (S, 3)


class FrameComm:
    """Cross-shard hooks of the frame step (JAX ``pipeline.py:162-211``).

    This class is the single-device identity. A point-sharded frame
    (``parallel/point_sharded.py:MeshComm``) runs the same frame on each
    shard's rows and combines per-patch statistics here: they are the only
    state that crosses shards."""

    is_sharded = False

    @property
    def eager_only(self) -> str | None:
        """Why a frame on this comm cannot be captured as a CUDA graph, or
        None where it can: the frame's ``eager_only`` (``graphs.py``). A
        comm can be captured where every exchange is a device op on the
        frame's card, issued on its stream; a sharded comm says so itself
        (``parallel/chunked.py:ChunkComm`` without an outer group)."""
        if self.is_sharded:
            return ("a sharded comm exchanges tensors through the host between the "
                    "shards' launches, so a sharded frame runs eagerly")
        return None

    def row_offset(self, n_local: int) -> int:
        """Global row index of this shard's first point."""
        return 0

    def reduce_patches(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a per-patch statistic across shards."""
        return x

    def lpr_stats(self, sp: SortedPoints, elig: torch.Tensor, num_lpr: int):
        """(sum, count) of each patch's num_lpr lowest eligible z (the
        unfused engine's hook)."""
        rank = segment_rank(elig, sp)
        tf = (elig & (rank < num_lpr)).to(torch.float32)
        sums = patch_reduce(torch.stack([sp.z * tf, tf], dim=1), sp.patch_id, sp.start)
        return sums[:, 0], sums[:, 1]

    def merge_lpr_table(self, z_at_rank, occ, elig_cnt, num_lpr: int):
        """Merge per-shard dense LPR candidate tables (the tiled engine's
        hook, ``ops/tiled_fit.py``): (S, num_lpr) z at each local rank slot,
        its occupancy and the (S,) local eligible count -> the global
        (lpr_sum, lpr_cnt).

        The identity form, and the contract of a custom comm: the local
        table is the global candidate set; the occupied slots are summed in
        rank (ascending z) order, the count clamped to num_lpr. The tiled
        engine's single-device path computes the same quantities from two
        columns without the table, so this method is the reference here,
        not the code that runs."""
        zero = torch.zeros((), dtype=z_at_rank.dtype, device=z_at_rank.device)
        return (seq_sum(torch.where(occ > 0.5, z_at_rank, zero)),
                torch.clamp_max(elig_cnt, float(num_lpr)))

    def meet_local(self, x, fn, most: int):
        """Every shard's ``x`` handed to one call ``fn([x, ...])`` in linear
        shard order, which returns one result a shard; each shard gets its
        own. Only where all the shards are threads of this process and at
        most ``most`` (the chunks of ``parallel/chunked.py``); None
        elsewhere, the same in every shard, and the caller then meets the
        shards through the other hooks. The identity comm has no shards to
        meet: None."""
        return None


def _fit_planes(
    carry: _PlaneCarry,
    sp: SortedPoints,
    q: tuple,
    mask_f: torch.Tensor,
    patch_gate: torch.Tensor,
    shift: torch.Tensor,
    comm: FrameComm,
):
    """Batched masked PCA plane fit with carry (reference estimate_plane
    :47-75). ``mask_f`` (P,) 0/1 selects the fit's points, ``patch_gate``
    (S,) which patches may update; a patch whose masked count is zero keeps
    its previous plane. Returns (new_carry, raw count)."""
    qx, qy, qz = q
    mom = comm.reduce_patches(patch_moment_sums(qx, qy, qz, mask_f, sp.patch_id, sp.start))
    n, mean, cov = moments_to_mean_cov(mom, shift)
    svals, normal = eigh3x3_descending(cov)
    d = -fma(normal[:, 2], mean[:, 2], fma(normal[:, 0], mean[:, 0],
                                           normal[:, 1] * mean[:, 1]))
    # a 1-point fit's non-finite plane -> the sentinel [0, 0, 0, 1e30];
    # decision-identical to ops/fit_kernel.py:apply_plane_sentinel
    fin = torch.isfinite(normal).all(dim=1) & torch.isfinite(d)
    normal = torch.where(fin[:, None], normal, torch.zeros((), device=d.device))
    d = torch.where(fin, d, torch.full_like(d, f32(1e30)))
    upd = patch_gate & (n > 0)
    u3 = upd[:, None]
    return _PlaneCarry(
        n=torch.where(upd, n, carry.n),
        mean=torch.where(u3, mean, carry.mean),
        normal=torch.where(u3, normal, carry.normal),
        d=torch.where(upd, d, carry.d),
        svals=torch.where(u3, svals, carry.svals),
    ), n


def _seed_mask(
    sp: SortedPoints,
    active: torch.Tensor,
    zone0_pt: torch.Tensor,
    gate_tab: torch.Tensor,
    sensor_height: torch.Tensor,
    th_seed: float,
    params: Params,
    comm: FrameComm,
) -> torch.Tensor:
    """Initial-seed selection over the active set (reference :77-149): LPR
    is the mean z of the lowest <= num_lpr active points (zone-0 patches
    skip points below margin * sensor_height first); the seeds are the
    active points with z < LPR + th_seed, gated per patch by ``gate_tab``
    (S,) f32. Returns an f32 0/1 mask."""
    margin_thr = f32(params.adaptive_seed_selection_margin) * sensor_height
    elig = active & (~zone0_pt | (sp.z >= margin_thr))
    lpr_sum, lpr_cnt = comm.lpr_stats(sp, elig, params.num_lpr)
    lpr = torch.where(
        lpr_cnt > 0, lpr_sum / torch.clamp_min(lpr_cnt, 1.0),
        torch.zeros((), device=lpr_sum.device),
    )
    look = patch_lookup(torch.stack([lpr, gate_tab], dim=1), sp.patch_id)
    seed = active & (sp.z < look[:, 0] + f32(th_seed)) & (look[:, 1] > 0.5)
    return seed.to(torch.float32)


def _sanitize_nonfinite(points: torch.Tensor) -> torch.Tensor:
    """Zero rows whose coordinates are non-finite or absurdly large: they
    become out-of-range (r = 0) and go to nonground, out of every statistic
    (the JAX package's deliberate deviation from the reference, kept so
    that the two engines see the same cloud)."""
    ok = (torch.abs(points[:, :3]) < _COORD_SANE).all(dim=1)
    return torch.where(ok[:, None], points, torch.zeros((), device=points.device))


def _masked_mean_stdev_rows(*groups):
    """Row-batched reference calc_mean_stdev (:557-566) over the last axis
    of each (vals, mask) group: rows with n <= 1 give zeros, else the
    sample stdev (n - 1). Returns one (mean, stdev, n) per group.

    The two float sums are ``ops.row_sum``, the order in which XLA:CPU
    compiles the JAX package's ``jnp.sum`` of these rows inside the frame,
    the groups' window steps shared (``ops.row_sums``: no bit changes, and
    each step is a node of the captured frame); the count is an exact
    integer sum, so any order gives its bits."""
    ms = [mask.to(torch.float32) for _, mask in groups]
    ns = [m.sum(dim=-1) for m in ms]
    zero = torch.zeros((), device=ms[0].device)
    vals = [torch.where(mask, v, zero) for v, mask in groups]
    means = [s / torch.clamp_min(n, 1.0) for s, n in zip(row_sums(*vals), ns)]
    ds = [v - mean[..., None] for v, mean in zip(vals, means)]
    sq = [d * d * m for d, m in zip(ds, ms)]
    out = []
    for mean, s, n in zip(means, row_sums(*sq), ns):
        ok = n > 1
        z = torch.zeros_like(mean)
        var = s / torch.clamp_min(n - 1.0, 1.0)
        out.append((torch.where(ok, mean, z), torch.where(ok, sqrt(var), z), n))
    return out


def _compact_rows(vals: torch.Tensor, acc_mask: torch.Tensor) -> torch.Tensor:
    """out[r, j] = the j-th mask-true value of row r (zeros beyond); exact,
    every output slot has at most one nonzero addend."""
    m = acc_mask.to(torch.float32)
    pos = torch.cumsum(m, dim=1) - m
    j = torch.arange(vals.shape[1], device=vals.device, dtype=pos.dtype)
    sel = (acc_mask[:, :, None] & (pos[:, :, None] == j)).to(torch.float32)
    vals = torch.where(acc_mask, vals, torch.zeros((), device=vals.device))
    return torch.sum(vals[:, :, None] * sel, dim=1)


def _write_at(buf: torch.Tensor, cnt: torch.Tensor, vals_c: torch.Tensor) -> torch.Tensor:
    """out[r] = buf[r] with vals_c[r] added from offset cnt[r] on (relies on
    buf being zero past cnt; writes past the capacity are dropped)."""
    cap = buf.shape[1]
    w = vals_c.shape[1]
    dev = buf.device
    rel = torch.arange(cap, device=dev)[None, :, None] - cnt[:, None, None]
    sel = (rel == torch.arange(w, device=dev)[None, None, :]).to(torch.float32)
    return buf + torch.sum(vals_c[:, None, :] * sel, dim=2)


def _append_rings(buf, cnt, vals_c, k, max_storage, do_trim, w):
    """Batched FIFO append + conditional trim of the (R,) ring buffers.

    Returns (buf_pre, buf_post, cnt_new, n_total): the thresholds are
    computed on buf_pre over n_total entries (the reference trims after
    computing them, patchworkpp.cpp:354-355, :372-373); buf_post is the
    trimmed carry, zero past its count. A ring that does not trim is still
    cut just below the capacity (the reference's vector has none)."""
    cap = buf.shape[1]
    buf_pre = _write_at(buf, cnt, vals_c)
    n_total = cnt + k
    excess = torch.where(
        do_trim,
        torch.clamp_min(n_total - max_storage, 0),
        torch.clamp_min(n_total - (cap - w), 0),
    )
    cnt_new = n_total - excess
    iota = torch.arange(cap, device=buf.device)
    src = (iota[None, :] + excess[:, None].to(torch.int64)) % cap
    rolled = torch.gather(buf_pre, 1, src)
    buf_post = torch.where(
        iota[None, :] < cnt_new[:, None], rolled, torch.zeros((), device=buf.device)
    )
    return buf_pre, buf_post, cnt_new.to(torch.int32), n_total


def _update_state(
    state: AdaptiveState,
    p: Params,
    ring_acc: torch.Tensor,
    ring_elev: torch.Tensor,
    ring_flat: torch.Tensor,
    *also,
):
    """End-of-frame adaptation (reference update_elevation_thr /
    update_flatness_thr :338-375): the ring-0 sensor height calibration
    and the flatness ``break`` freeze, all rings as one batched op set.

    ``also`` holds further (vals, mask) row groups of the frame (TGR's),
    whose statistics share the buffers' sums (see
    ``_masked_mean_stdev_rows``). Returns the new state and one
    (mean, stdev, n) per group of ``also``."""
    n_roi = p.num_rings_of_interest
    cap = state.elev_buf.shape[1]
    w = ring_elev.shape[1]
    dev = ring_acc.device
    iota = torch.arange(cap, device=dev)

    k = torch.sum(ring_acc, dim=1).to(torch.int32)
    elev_c = _compact_rows(ring_elev, ring_acc)
    flat_c = _compact_rows(ring_flat, ring_acc)

    # elevation: every ring independent ('continue' on empty)
    buf_pre_e, buf_post_e, cnt_new_e, n_tot_e = _append_rings(
        state.elev_buf[:n_roi], state.elev_cnt[:n_roi], elev_c, k,
        p.max_elevation_storage,
        do_trim=torch.ones(n_roi, dtype=torch.bool, device=dev), w=w,
    )
    # flatness: a starved ring freezes itself and every later ring
    n_tot_pre = state.flat_cnt[:n_roi] + k
    do = torch.cumsum((n_tot_pre <= 1).to(torch.int32), dim=0) == 0
    buf_pre_f, buf_post_f, cnt_new_f, n_tot_f = _append_rings(
        state.flat_buf[:n_roi], state.flat_cnt[:n_roi], flat_c, k,
        p.max_flatness_storage, do_trim=do, w=w,
    )
    # both buffers' statistics as one batch of rows (each row's sums are
    # its own, so batching changes no bit)
    (mean, stdev, _), *also_stats = _masked_mean_stdev_rows(
        (torch.cat([buf_pre_e, buf_pre_f]),
         iota[None, :] < torch.cat([n_tot_e, n_tot_f])[:, None]),
        *also,
    )
    mean_e, mean_f = mean[:n_roi], mean[n_roi:]
    stdev_e, stdev_f = stdev[:n_roi], stdev[n_roi:]

    # ring 0 keeps mean + 3 stdev, the others mean + 2 stdev, the multiply
    # fused into the add as XLA:CPU compiles it
    factor = torch.where(torch.arange(n_roi, device=dev) == 0, 3.0, 2.0)
    elev_thr = state.elevation_thr.clone()
    elev_thr[:n_roi] = torch.where(
        n_tot_e > 0, fma(factor, stdev_e, mean_e), state.elevation_thr[:n_roi]
    )
    sh = torch.where(n_tot_e[0] > 0, -mean_e[0], state.sensor_height)
    flat_thr = state.flatness_thr.clone()
    flat_thr[:n_roi] = torch.where(
        do, mean_f + stdev_f, state.flatness_thr[:n_roi]
    )

    def _set(full, rows):
        out = full.clone()
        out[:n_roi] = rows
        return out

    return AdaptiveState(
        sensor_height=sh,
        elevation_thr=elev_thr,
        flatness_thr=flat_thr,
        elev_buf=_set(state.elev_buf, buf_post_e),
        elev_cnt=_set(state.elev_cnt, cnt_new_e),
        flat_buf=_set(state.flat_buf, buf_post_f),
        flat_cnt=_set(state.flat_cnt, cnt_new_f),
        plane=state.plane,
    ), also_stats


def carry_planes(plane: torch.Tensor, start: torch.Tensor, counts: torch.Tensor,
                 sid: torch.Tensor, npz: int, inherited: torch.Tensor):
    """The reference's plane members carried from patch to patch
    (patchworkpp.cpp:49: ``estimate_plane`` returns early on an empty
    input, so the members keep the last fit's plane, and A-GLE, TGR and
    the ring samples of an empty processed patch read it), where every
    patch of the CZM is processed (``num_min_pts`` < 1).

    ``plane`` (S, PLANE_WIDTH) holds each patch's final plane, ``start``
    (PLANE_WIDTH,) the plane the state carries in from the previous frame
    (zeros in a fresh state, as in a fresh reference object), ``counts``
    (S,) each patch's points, ``sid`` (S,) int64 the patch index and
    ``npz`` the CZM's patches (the rest of the S are padding, which no
    frame processes). A patch without points takes the plane of the
    nearest preceding patch with points, in flat patch order (the
    reference's zone, ring, sector loop), or ``start`` where none precedes
    it; the state then carries the plane of the CZM's last patch. Returns
    (the planes, that next plane), and writes the count of patches that
    inherited into the 0-d int32 ``inherited``."""
    has = counts > 0
    # each patch's nearest patch with points at or before it (itself, if it
    # has points: the patch index grows); -1 (none) picks the table's last
    # row, the carried-in plane
    last = torch.cummax(torch.where(has, sid, -1), dim=0).values
    out = torch.cat([plane, start[None, :]], dim=0)[last]
    torch.sum(~has[:npz], dim=0, dtype=torch.int32, out=inherited)
    return out, out[npz - 1]


FUSED_MODES = (False, "grid", "grid_iota", "onehot", "tiled")


def make_frame_fn(
    params: Params, geom: CZMGeometry | None = None, device="cuda", fused=None,
    comm: FrameComm | None = None,
):
    """Build the frame step ``fn(state, points, npts) -> (state, FrameResult)``.

    ``points`` is a (P, 4) float32 tensor on ``device`` (padded), ``npts``
    the number of real rows: an int, or a 0-d integer tensor on ``device``
    (the same bits). With a sharded ``comm``
    (``parallel/``) the step is the per-shard program: ``points`` are this
    shard's rows, ``npts`` the global count, the mask covers this shard's
    rows and every per-patch output is the merged one. ``fused`` picks the
    engine, as in the JAX package (``pipeline.py:367-438``):

    - ``None`` (= ``"tiled"``), ``True`` (= ``"grid"``), ``"grid"``,
      ``"grid_iota"``: the tiled layout and the fit kernel K1
      (``ops/fit_kernel_grid.py``; the TPU's two prefix modes are one
      kernel here);
    - ``"onehot"``: the tiled layout and the unrolled fit kernel K2
      (``ops/fit_kernel.py:fused_fit``);
    - ``False``: the unfused engine on the (patch, z)-sorted layout, PyTorch
      ops and the per-patch sum kernel KR (``ops/patch_reduce_kernel.py``).

    The fit kernels run as CUDA kernels on a CUDA device (the default) and
    as their plain versions when the caller asks for ``device="cpu"``.

    Under a sharded comm the tiled engine runs the fit program cut at its
    cross-shard points, the comm's LPR merge and moment reduction between
    its passes: on the card the sharded fit kernel KS
    (``ops/sharded_fit.py``, ``csrc/fit_sharded.cu``: one cluster launch
    for the chunks of a process, else about a dozen launches a shard), on
    the CPU its plain version, the composed
    ``ops/tiled_fit.py:tiled_fit(comm=...)``. K1 holds a whole patch in one
    CTA and has no point at which to meet the other shards, so its launch
    count reads 0 on such frames (the JAX package's sharded tiled engine is
    XLA, never Pallas). The kernel modes raise, in the JAX package's
    words.

    The step's ``eager_only`` is the comm's (:attr:`FrameComm.eager_only`):
    None where ``graphs.CapturedFrame`` may capture it as a CUDA graph, else
    the reason it runs eagerly.

    Where ``num_min_pts`` < 1 a processed patch can be empty, and the tail
    carries the planes across patches and frames as the reference's members
    do (:func:`carry_planes`, the state's ``plane``); the step's
    ``inherited_planes`` is then a 0-d int32 tensor on ``device`` that each
    frame overwrites with its count of inherited planes, and None where the
    carry is not built (a no-op there)."""
    p = params
    comm = comm or FrameComm()
    sharded = comm.is_sharded
    if fused is None:
        fused = "tiled"
    if fused is True:
        fused = "grid"
    if fused not in FUSED_MODES:
        raise ValueError(
            f"unknown fused mode {fused!r}: expected False, True/'grid', "
            "'grid_iota' (in-kernel static prefix triangle), 'tiled' (the "
            "XLA tiled engine — the shardable fused path), or 'onehot' "
            "(the 'scan' variant was removed)"
        )
    if sharded and fused not in (False, "tiled"):
        raise ValueError(
            f"fused={fused!r} is a single-chip Pallas kernel and cannot run "
            "under a point-sharded comm; use fused='tiled' (the same tiled "
            "design composed in XLA so cross-shard collectives interleave "
            "at pass boundaries) or fused=False"
        )
    geom = geom or CZMGeometry.create(p)
    dev = torch.device(device)
    tables = build_static_tables(p, geom)
    npz = geom.num_patches
    spad = geom.spad
    if fused in ("grid", "grid_iota", "onehot"):
        check_onehot_limits(p, spad, fused)

    max_storage_ok = BUF_CAP - tables.max_ring_patches
    for nm in ("max_elevation_storage", "max_flatness_storage"):
        if getattr(p, nm) > max_storage_ok:
            raise ValueError(
                f"{nm}={getattr(p, nm)} exceeds {max_storage_ok} (BUF_CAP="
                f"{BUF_CAP} minus the {tables.max_ring_patches} samples a "
                "ring can add per frame); the adaptive buffers would drop samples"
            )

    cring_tab = torch.as_tensor(tables.cring, device=dev)
    shift_tab = torch.as_tensor(tables.shift, device=dev)
    sid = torch.arange(spad, device=dev)
    zone0_f = (sid < tables.num_zone0).to(torch.float32)
    snap_off, carry2_off, _ = out_layout(p)
    n_roi = p.num_rings_of_interest
    w = tables.max_ring_patches
    sentinel_plane = torch.tensor([0.0, 0.0, 0.0, f32(1e30)], device=dev)
    # a column reads NaN where the fit's count equals its entry: a 1-point
    # fit leaves all but the mean NaN (a count is never -1)
    nan_n = torch.tensor([-1.0] * 3 + [1.0] * (PLANE_WIDTH - 3), device=dev)
    nan = torch.full((), float("nan"), device=dev)
    # the in-order plane carry across patches: only where a processed patch
    # can be empty (num_min_pts < 1, where every patch is processed;
    # elsewhere it would change nothing)
    carries = p.num_min_pts < 1
    inherited_planes = torch.zeros((), dtype=torch.int32, device=dev) if carries else None

    def _rings(vals: torch.Tensor) -> torch.Tensor:
        """(S,) per-patch values -> (n_roi, w) zero-padded ring rows."""
        out = torch.zeros((n_roi, w), dtype=vals.dtype, device=dev)
        for ci, (a, b) in enumerate(tables.ring_slices):
            out[ci, : b - a] = vals[a:b]
        return out

    def _planes(state, normal, mean, svals, d, fit_n, counts):
        """Each patch's final plane as the reference's members hold it after
        the patch, (S, PLANE_WIDTH): [mean, normal, eigenvalues, d]. A fit of
        one point has the reference's NaN covariance (0/0), so its normal,
        eigenvalues and d read NaN (the fit tables hold the sentinel plane,
        which the label replay keeps: the decisions are the same). Also the
        state's plane for the next frame: where the frame builds the carry,
        that of :func:`carry_planes` (which writes the frame's count of
        inherited planes into ``inherited_planes``), else the state's own."""
        plane = torch.cat([mean, normal, svals, d[:, None]], dim=1)
        plane = torch.where(fit_n[:, None] == nan_n, nan, plane)
        if not carries:
            return plane, state.plane
        return carry_planes(plane, state.plane, counts, sid, npz, inherited_planes)

    def _finalize(
        state, normal, mean, svals, d, fit_n, counts, g_count, processed, proc_f,
        final_plane_tab, vpf_tables, pid_o, points,
    ):
        """A-GLE cascade, TGR, state update, original-order labels."""
        plane, next_plane = _planes(state, normal, mean, svals, d, fit_n, counts)
        mean, normal, svals = plane[:, 0:3], plane[:, 3:6], plane[:, 6:9]
        zero = torch.zeros((), device=dev)
        one = torch.ones((), device=dev)
        uprightness = normal[:, 2]
        elevation = mean[:, 2]
        flatness = svals[:, 2]
        sv0, sv1 = svals[:, 0], svals[:, 1]
        line_variable = torch.where(
            sv1 != 0, sv0 / sv1, torch.full_like(sv0, _F32_MAX)
        )
        heading = (
            mean[:, 0] * normal[:, 0] + mean[:, 1] * normal[:, 1]
        ) + mean[:, 2] * normal[:, 2]

        is_upright = uprightness > f32(p.uprightness_thr)
        is_near = cring_tab < n_roi
        ring_idx = torch.clamp_max(cring_tab, n_roi - 1).to(torch.int64)
        is_not_elevated = is_near & (elevation < state.elevation_thr[ring_idx])
        is_flat = is_near & (flatness < state.flatness_thr[ring_idx])
        heading_out = heading < 0.0

        accept = processed & is_upright & is_not_elevated & is_near
        ground_patch = (
            processed
            & is_upright
            & (~is_near | (heading_out & (is_not_elevated | is_flat)))
        )
        candidate = (
            processed & is_upright & is_near & heading_out
            & ~is_not_elevated & ~is_flat
        )

        # ---- TGR per ring of interest (reference :291-304, :402-464).
        ring_flat = _rings(flatness)
        ring_acc = _rings(accept)
        ring_elev = _rings(elevation)
        revert_patch = torch.zeros(spad, dtype=torch.bool, device=dev)
        if p.enable_TGR:
            ring_cand = _rings(candidate)
            ring_gcnt = _rings(g_count)
            ring_linev = _rings(line_variable)
            # flush_from at ring ci = 1 + the last ring j < ci with
            # candidates (0 if none): an exclusive cumulative max
            ring_ids = torch.arange(n_roi, device=dev)
            adv = torch.where(ring_cand.any(dim=1), ring_ids + 1, 0)
            ff = torch.cat(
                [torch.zeros(1, dtype=adv.dtype, device=dev),
                 torch.cummax(adv, dim=0).values[:-1]]
            )
            include = (ring_ids[None, :] >= ff[:, None]) & (
                ring_ids[None, :] <= ring_ids[:, None]
            )  # (target ring, source ring)
            m = ring_acc[None, :, :] & include[:, :, None]
            tgr_rows = ((ring_flat[None].expand(m.shape).reshape(n_roi, -1),
                         m.reshape(n_roi, -1)),)
        else:
            tgr_rows = ()
        # TGR's sums share the state update's steps (neither reads the other)
        new_state, tgr_stats = _update_state(
            state, p, ring_acc, ring_elev, ring_flat, *tgr_rows)
        if p.enable_TGR:
            (mean_f, stdev_f, _), = tgr_stats
            mu = fma(stdev_f, 1.5, mean_f)[:, None]  # contracted by XLA:CPU
            F = ring_flat
            # exp in float64, rounded: the float32 exp of CPU and CUDA
            # libraries differ in the last ulp
            e = torch.exp(((F - mu) / div(mu, 10.0)).double()).float()
            prob_flat = 1.0 / (1.0 + e)
            big_flat = (ring_gcnt > 1500) & (F < f32(p.th_dist * p.th_dist))
            prob_flat = torch.where(big_flat, one, prob_flat)
            prob_line = torch.where(ring_linev > 8.0, zero, one)
            revert_ring = ring_cand & (prob_line * prob_flat > 0.5)
            for ci, (a, b) in enumerate(tables.ring_slices):
                revert_patch[a:b] = revert_ring[ci, : b - a]

        # ---- per-point labels in ORIGINAL order (C13): replay the peel
        # tests and the final distance test against the per-patch tables
        # (the kernel KL on the card, ops/label_replay_kernel.py). Each
        # R-VPF snapshot's gate folds into a sentinel plane whose |distance|
        # never passes the peel threshold.
        code = 2.0 * proc_f + (ground_patch | revert_patch).to(torch.float32)
        vpf_cols = [
            torch.where(t[:, 4:5] > 0.5, t[:, 0:4], sentinel_plane[None, :])
            for t in vpf_tables
        ]
        label_tab = torch.cat([final_plane_tab, code[:, None]] + vpf_cols, dim=1)
        ground, num_ground = label_replay(
            points, pid_o, label_tab, f32(p.th_dist), f32(p.th_dist_v))

        if carries:
            new_state = dataclasses.replace(new_state, plane=next_plane)
        result = FrameResult(
            ground_mask=ground,
            num_ground=comm.reduce_patches(num_ground),
            patch_mean=mean[:npz],
            patch_normal=normal[:npz],
            patch_svals=svals[:npz],
            patch_processed=processed[:npz],
        )
        return new_state, result

    def _local_npts(points: torch.Tensor, npts):
        """The real rows among this shard's: the global count less the
        shard's first row, clamped to [0, rows] (below 0 on the shards
        past the last real point, above the rows on those before it). A
        0-d tensor (a captured frame's static ``npts``, graphs.py) is
        clamped on its device, the shard's first row a constant of the
        build: a host read would bake the capture's value into the graph."""
        rows = points.shape[0]
        off = comm.row_offset(rows)
        if isinstance(npts, torch.Tensor):
            return torch.clamp(npts - off if off else npts, 0, rows)
        return min(max(int(npts) - off, 0), rows)

    def fit_inputs(state: AdaptiveState, points: torch.Tensor, npts) -> FitInputs:
        """Sanitize, bin and tile one padded cloud: everything the fit
        kernel and the frame's tail read."""
        with record_function("stage_rnr_czm"):
            points = _sanitize_nonfinite(points.to(torch.float32))
            bins = bin_points(points, _local_npts(points, npts), state.sensor_height, p, geom)
        with record_function("stage_sort"):
            tp = build_tiled(
                points[:, :3], bins.patch_id,
                counts=factored_patch_counts(bins, geom, spad), width=spad,
            )
        counts = comm.reduce_patches(tp.counts)
        processed = (counts >= p.num_min_pts) & (sid < npz)
        proc_f = processed.to(torch.float32)

        nt = tp.xyz.shape[0] // TILE
        # gates: [processed, shift(3), zone0, 0, 0, 0]; sentinel tiles clamp
        # to patch spad-1, which is never zone 0 nor processed
        gates = torch.cat(
            [
                proc_f[:, None], shift_tab, zone0_f[:, None],
                torch.zeros((spad, 3), device=dev),
            ],
            dim=1,
        ).contiguous()
        margin_thr = f32(p.adaptive_seed_selection_margin) * state.sensor_height
        return FitInputs(
            xs=tp.xyz[:, 0].reshape(nt, TILE).contiguous(),
            ys=tp.xyz[:, 1].reshape(nt, TILE).contiguous(),
            zs=tp.xyz[:, 2].reshape(nt, TILE).contiguous(),
            valid_f=tp.valid.to(torch.float32).reshape(nt, TILE),
            tile_patch=torch.clamp_max(tp.tile_patch, spad - 1),
            pad_start=tp.pad_start,
            gates=gates,
            consts=torch.cat([margin_thr.reshape(1), torch.zeros(7, device=dev)]),
            counts=counts,
            processed=processed,
            points=points,
            patch_id=bins.patch_id,
        )

    def frame_fused(state: AdaptiveState, points: torch.Tensor, npts):
        fi = fit_inputs(state, points, npts)
        args = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                fi.gates, fi.consts, p)
        with record_function("stage_fused_fit"):
            if fused == "onehot":
                # K2's table is not masked by counts (pipeline.py:809-815)
                out = fused_fit(*args)
            else:
                if not sharded:
                    table = fused_fit_grid(*args)
                elif dev.type == "cuda":
                    table = sharded_fit(*args, comm)
                else:
                    table = tiled_fit(*args[:7], fi.consts[0], p, comm=comm)
                # the overflow bucket and empty patches hold no fit
                out = torch.where(fi.counts[:, None] > 0, table, torch.zeros((), device=dev))
        with record_function("stage_gle_tail"):
            return _tail(state, fi, out)

    def _tail(state: AdaptiveState, fi: FitInputs, out: torch.Tensor):
        """Fit table -> eigenvalues, snapshot tables, then _finalize."""
        normal = out[:, OUT_NORMAL:OUT_NORMAL + 3]
        mean = out[:, OUT_MEAN:OUT_MEAN + 3]
        d = out[:, OUT_D]
        fit_n = out[:, OUT_N]
        g_count = out[:, OUT_GCOUNT]
        # the final covariance's eigenvalues, which the fit kernels write
        # (the JAX package's tail computes them from the covariance columns)
        svals = out[:, carry2_off + 4:carry2_off + 7]

        # R-VPF snapshots: kernel layout [gate, nx, ny, nz, d] -> label-pass
        # layout [nx, ny, nz, d, gate]
        vpf_tables = []
        if p.enable_RVPF:
            for it in range(p.num_iter):
                a = snap_off + it * 5
                snap = out[:, a:a + 5]
                vpf_tables.append(torch.cat([snap[:, 1:5], snap[:, 0:1]], dim=1))
        final_plane_tab = out[:, carry2_off:carry2_off + 4]

        return _finalize(
            state, normal, mean, svals, d, fit_n, fi.counts, g_count, fi.processed,
            fi.processed.to(torch.float32), final_plane_tab, vpf_tables,
            fi.patch_id, fi.points,
        )

    def frame(state: AdaptiveState, points: torch.Tensor, npts):
        """The unfused engine (JAX pipeline.py:638-743)."""
        with record_function("stage_rnr_czm"):
            points = _sanitize_nonfinite(points.to(torch.float32))
            bins = bin_points(points, _local_npts(points, npts), state.sensor_height, p, geom)
        pid_o = bins.patch_id
        with record_function("stage_sort"):
            sp = sort_by_patch(points[:, 0], points[:, 1], points[:, 2], pid_o, spad)
        counts = comm.reduce_patches(patch_counts(sp))
        processed = (counts >= p.num_min_pts) & (sid < npz)
        proc_f = processed.to(torch.float32)

        pid_s = sp.patch_id
        zone0_pt = pid_s < tables.num_zone0
        shl = patch_lookup_cols(shift_tab, pid_s)
        q = (sp.x - shl[0], sp.y - shl[1], sp.z - shl[2])
        active = patch_lookup(proc_f[:, None], pid_s)[:, 0] > 0.5
        zeros = torch.zeros(spad, device=dev)
        zeros3 = torch.zeros((spad, 3), device=dev)
        carry = _PlaneCarry(n=zeros, mean=zeros3, normal=zeros3, d=zeros, svals=zeros3)

        def _dist(look):
            return plane_dist(sp.x, sp.y, sp.z, look[0], look[1], look[2], look[3])

        # R-VPF (reference :477-508): peel vertical planes, zone 0 only
        vpf_tables = []
        if p.enable_RVPF:
            with record_function("stage_rvpf"):
                alive = processed
                for _ in range(p.num_iter):
                    seeds_f = _seed_mask(
                        sp, active, zone0_pt, alive.to(torch.float32),
                        state.sensor_height, p.th_seeds_v, p, comm,
                    )
                    carry, _ = _fit_planes(carry, sp, q, seeds_f, alive, shift_tab, comm)
                    vert = (
                        alive & (sid < tables.num_zone0)
                        & (carry.normal[:, 2] < f32(p.uprightness_thr))
                    )
                    plane_tab = torch.cat(
                        [carry.normal, carry.d[:, None], vert.to(torch.float32)[:, None]],
                        dim=1,
                    )
                    vpf_tables.append(plane_tab)
                    look = patch_lookup_cols(plane_tab, pid_s)
                    peel = (
                        active & (look[4] > 0.5)
                        & (torch.abs(_dist(look)) < f32(p.th_dist_v))
                    )
                    active = active & ~peel
                    alive = vert

        # R-GPF (reference :510-543): seed fit, then num_iter distance refits
        with record_function("stage_rgpf"):
            seeds_f = _seed_mask(
                sp, active, zone0_pt, proc_f, state.sensor_height, p.th_seeds, p, comm,
            )
            carry, _ = _fit_planes(carry, sp, q, seeds_f, processed, shift_tab, comm)
            g_count = zeros
            final_plane_tab = None
            for _ in range(p.num_iter):
                final_plane_tab = torch.cat([carry.normal, carry.d[:, None]], dim=1)
                look = patch_lookup_cols(final_plane_tab, pid_s)
                g_f = (active & (_dist(look) < f32(p.th_dist))).to(torch.float32)
                carry, g_count = _fit_planes(carry, sp, q, g_f, processed, shift_tab, comm)

        with record_function("stage_gle_tail"):
            return _finalize(
                state, carry.normal, carry.mean, carry.svals, carry.d, carry.n, counts,
                g_count, processed, proc_f, final_plane_tab, vpf_tables, pid_o, points,
            )

    if fused is False:
        frame.eager_only = comm.eager_only
        frame.inherited_planes = inherited_planes
        return frame
    # the fit kernel's inputs for a cloud, as the frame builds them (for
    # holding the kernel against its plain version at the frame's shapes)
    frame_fused.fit_inputs = fit_inputs
    frame_fused.eager_only = comm.eager_only
    frame_fused.inherited_planes = inherited_planes
    return frame_fused


def make_sequence_fn(
    params: Params, geom: CZMGeometry | None = None, device="cuda", fused=None,
    comm: FrameComm | None = None,
):
    """Build ``fn(state, stack, npts) -> (state, FrameResult)`` over a
    (B, P, 4) stack of scans: the frame step (engine ``fused`` and ``comm``,
    as in :func:`make_frame_fn`) in order, the adaptive state threaded from
    each frame to the next, every FrameResult field stacked on a leading B
    axis. The JAX package runs the chain as one device program; here the
    frame is one captured CUDA graph, replayed B times
    (``graphs.CompiledSequence``: one graph per capacity, whatever B is;
    on the CPU its static-buffer step runs eagerly). A comm that exchanges
    through the host (``FrameComm.eager_only``) runs as a loop of eager
    frames."""
    frame = make_frame_fn(params, geom, device, fused, comm)
    if frame.eager_only:
        return sequence_of(frame)
    from patchworkpp_tpu_torch.graphs import CompiledSequence

    return CompiledSequence(frame, params, device)


def sequence_of(frame):
    """The state-chained loop of a frame step ``frame(state, points, npts)``
    over a (B, P, 4) stack: ``fn(state, stack, npts) -> (state,
    FrameResult)`` with every field stacked on a leading B axis."""

    def sequence(state: AdaptiveState, stack: torch.Tensor, npts: List[int]):
        results = []
        for i in range(stack.shape[0]):
            state, res = frame(state, stack[i], int(npts[i]))
            results.append(res)
        return state, FrameResult(
            *(torch.stack(list(f)) for f in zip(*results))
        )

    return sequence


@functools.lru_cache(maxsize=8)
def _cached_frame_fn(params: Params, device: torch.device):
    from patchworkpp_tpu_torch.graphs import CompiledFrame

    return CompiledFrame(make_frame_fn(params, device=device), params, device)


def segment(state: AdaptiveState, points: torch.Tensor, npts, params: Params):
    """One frame through a cached compiled step (JAX ``pipeline.py:1020-1028``):
    ``(state, FrameResult)`` of the default engine, from a captured frame
    kept per ``params``, device and capacity (``graphs.CompiledFrame``; on
    the CPU its static-buffer step runs eagerly). ``state`` is not
    modified; the result stays valid after later calls. Threads may call it
    at once, each on any CUDA stream: the frame takes one call at a time,
    and on the card a call's work follows the previous call's."""
    return _cached_frame_fn(params, points.device)(state, points, npts)
