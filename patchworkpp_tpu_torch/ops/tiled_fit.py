"""The fit pass program on the tiled layout, in plain PyTorch: the plain
version of the CUDA fit kernels K1 (csrc/fit_grid.cu, wrapped by
ops/fit_kernel_grid.py) and, with plain f32 per-patch sums, K2
(csrc/fit_onehot.cu, ops/fit_kernel.py:fused_fit_reference), and the tiled
engine's CPU path.

Port of ``patchworkpp_tpu/ops/tiled_fit.py``, itself the TPU grid kernel
``fused_fit_grid``'s program written out as XLA ops. Per patch and pass
(reference seed selection patchworkpp.cpp:77-149, R-VPF/R-GPF loop
:467-549):

  SEEDFIT  peel by the previous vertical snapshot -> zone-0 margin
           eligibility -> LPR over the lowest num_lpr eligible z (exclusive
           tile prefix + in-tile lane rank) -> seed mask -> moments -> fit
           -> vertical snapshot
  FITDIST  signed-distance mask -> moments -> fit (the last pass saves the
           plane it tested against and g_count)

Reduction order is part of the contract. Each tile's 128 lanes are summed
in XLA:CPU's order (``ops.row_sum``), as the JAX engine sums them; the
plane distances and the fit math round as XLA:CPU contracts them
(``ops.plane_dist``, ``ops.fma``). Each per-tile sum is split
into three round-to-nearest bf16 parts; the parts are accumulated in f32
over the patch's tiles in tile order and re-added as (hi + mid) + lo, the
JAX grid kernel's movement profile (a 1-ulp covariance difference once
flipped an uprightness decision, see _rne_bf16_split3); K2 adds the tile
sums in plain f32 instead (``_reduce_tiles_f32``). Each CUDA kernel does
exactly these operations, so it agrees with this version bit for bit on
any device.
"""

from __future__ import annotations

import torch

from patchworkpp_tpu_torch.ops import f32, plane_dist, row_sum
from patchworkpp_tpu_torch.ops.eigen3 import eig3_plane_columns
from patchworkpp_tpu_torch.ops.fit_kernel import (
    OUT_CARRY2,
    OUT_COLS,
    OUT_SNAP,
    PLANE_COLS,
    _lane_prefix_exclusive,
    plane_row_from_moments,
)
from patchworkpp_tpu_torch.ops.fit_kernel_grid import (
    K_FITDIST,
    K_SEEDFIT,
    _pass_config,
)
from patchworkpp_tpu_torch.ops.tiled import TILE
from patchworkpp_tpu_torch.params import Params


def out_layout(params: Params):
    """(snap_off, carry2_off, out_cols) of the per-patch result table: the
    canonical 48 columns for num_iter <= 3, extended by 5 columns per extra
    R-VPF snapshot beyond that. The 3 columns after carry2 hold the
    eigenvalues of the final covariance (``OUT_SVALS`` in the canonical
    layout), which the frame's tail reads; the JAX package's tail computes
    them itself, so its extended table is 3 columns narrower."""
    nsnap = params.num_iter if params.enable_RVPF else 0
    if nsnap <= 3:
        return OUT_SNAP, OUT_CARRY2, OUT_COLS
    carry2 = OUT_SNAP + 5 * nsnap
    return OUT_SNAP, carry2, carry2 + 7


def _rne_part(v: torch.Tensor):
    """(bf16_rne(v) as f32, v - that): the top 16 bits after rounding the
    f32 pattern to nearest-even, in integer arithmetic."""
    bits = v.contiguous().view(torch.int32)
    lsb = (bits >> 16) & 1
    kept = ((bits + 0x7FFF + lsb) & -65536).view(torch.float32)
    return kept, v - kept


def _rne_bf16_split3(x: torch.Tensor):
    """f32 -> three bf16-representable f32 parts that sum back to x exactly
    (the third residual fits in 8 significand bits)."""
    hi, r1 = _rne_part(x)
    mid, r2 = _rne_part(r1)
    lo, _ = _rne_part(r2)
    return hi, mid, lo


def tile_ranges(pad_start: torch.Tensor, nt: int):
    """Gather map from patches to their tiles, in tile order.

    Returns (idx, ok), both (S, T) with T the largest tile count of a patch:
    ``idx[s, j]`` is patch s's j-th tile, valid where ``ok[s, j]``. Patch
    s owns tiles ``pad_start[s]/128 .. pad_start[s+1]/128``; the sentinel
    tiles past ``pad_start[S]`` carry no active point and are left out."""
    ps = pad_start.to(torch.int64) // TILE
    ts, cnt = ps[:-1], ps[1:] - ps[:-1]
    tmax = int(cnt.max()) if cnt.numel() else 0
    j = torch.arange(tmax, device=pad_start.device)
    idx = torch.clamp_max(ts[:, None] + j[None, :], max(nt - 1, 0))
    return idx, j[None, :] < cnt[:, None]


def _reduce_tiles_split3(v: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """(NT, C) per-tile sums -> (S, C) per-patch sums: rne-bf16x3 parts,
    each accumulated in f32 over the patch's tiles in tile order, re-added
    as (hi + mid) + lo."""
    c = v.shape[1]
    parts = torch.cat(_rne_bf16_split3(v), dim=1)  # (NT, 3C)
    g = torch.where(ok[..., None], parts[idx], torch.zeros((), device=v.device))
    acc = torch.zeros((idx.shape[0], 3 * c), dtype=v.dtype, device=v.device)
    for j in range(idx.shape[1]):
        acc = acc + g[:, j]
    return (acc[:, :c] + acc[:, c:2 * c]) + acc[:, 2 * c:]


def _reduce_tiles_f32(v: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """(NT, C) per-tile sums -> (S, C) per-patch sums: plain f32 adds over
    the patch's tiles in tile order (the unrolled kernel K2's reduction)."""
    g = torch.where(ok[..., None], v[idx], torch.zeros((), device=v.device))
    acc = torch.zeros((idx.shape[0], v.shape[1]), dtype=v.dtype, device=v.device)
    for j in range(idx.shape[1]):
        acc = acc + g[:, j]
    return acc


def _tile_moments(xs, ys, zs, sx, sy, sz, mask):
    """(NT, 128) masked monomials -> (NT, 10) per-tile sums, in the kernels'
    monomial order ((qx * qx) * mask, not (qx * mask) ** 2)."""
    qx = xs - sx
    qy = ys - sy
    qz = zs - sz
    return row_sum(torch.stack(
        [
            mask, qx * mask, qy * mask, qz * mask,
            qx * qx * mask, qx * qy * mask, qx * qz * mask,
            qy * qy * mask, qy * qz * mask, qz * qz * mask,
        ],
        dim=1,
    ))


def _lpr_table(zs, take, grank, num_lpr: int):
    """(NT, 2 * num_lpr) per-tile [z at each shard rank slot | occupancy]:
    slot r of a tile holds the z of its lane whose rank among the shard's
    eligible points of the patch is r. ``take`` implies ``grank <
    num_lpr``, and each (patch, slot) has one point, so every per-patch sum
    of these columns is an exact selection."""
    nt = zs.shape[0]
    slot = torch.where(take > 0.5, grank, num_lpr).to(torch.int64)  # num_lpr: dropped
    z_tab = torch.zeros((nt, num_lpr + 1), dtype=zs.dtype, device=zs.device)
    occ = torch.zeros_like(z_tab)
    z_tab.scatter_(1, slot, zs)
    occ.scatter_(1, slot, take)
    return torch.cat([z_tab[:, :num_lpr], occ[:, :num_lpr]], dim=1)


class FitProgram:
    """The fit program on one shard's tiled layout, cut at its passes: the
    per-frame constants, the state the passes carry (active rows, plane,
    alive, snapshots, g_count, the final pass's plane) and each slice of a
    pass as a method. :func:`tiled_fit` runs the slices in order;
    ``ops/sharded_fit.py`` runs them as the phases of the sharded fit
    kernel. Arguments as :func:`tiled_fit`."""

    def __init__(self, xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, margin_thr,
                 params: Params, reduce=_reduce_tiles_split3):
        p = self.params = params
        self.xs, self.ys, self.zs = xs, ys, zs
        self.reduce = reduce
        self.margin_thr = margin_thr
        nt = xs.shape[0]
        spad = gates_p.shape[0]
        dev = self.dev = xs.device
        tpc = self.tpc = tile_patch.reshape(-1).to(torch.int64)
        (self.npasses, self.kind, self.peel_slot, self.snap_slot, self.gate_alive,
         self.final, self.th) = _pass_config(p)
        self.idx, self.ok = tile_ranges(pad_start, nt)

        self.gates_p = gates_p
        self.proc_p = gates_p[:, 0]
        self.zone0_p = gates_p[:, 4] > 0.5
        gt = gates_p[tpc]
        self.sx, self.sy, self.sz = gt[:, 1:2], gt[:, 2:3], gt[:, 3:4]
        self.zone0_t = gt[:, 4:5] > 0.5
        # first tile of each tile's patch run, for the exclusive tile prefix
        self.first = (pad_start.to(torch.int64) // TILE)[tpc]

        self.active = valid_f * gt[:, 0:1]
        self.plane = torch.zeros((spad, PLANE_COLS), dtype=torch.float32, device=dev)
        self.alive = self.proc_p
        self.snap_off, self.carry2_off, self.out_cols = out_layout(p)
        nsnap = (self.carry2_off - self.snap_off) // 5
        self.snaps = [torch.zeros((spad, 5), device=dev) for _ in range(nsnap)]
        self.g_count = torch.zeros(spad, device=dev)
        self.final_tab = torch.zeros((spad, 4), device=dev)
        self.one = torch.ones((), device=dev)
        self.zero = torch.zeros((), device=dev)

    def gate(self, i: int) -> torch.Tensor:
        """(S,) pass i's fit gate: alive (R-VPF) or processed (R-GPF)."""
        return self.alive if self.gate_alive[i] else self.proc_p

    def peel(self, i: int) -> None:
        """SEEDFIT: drop the rows within th_dist_v of the peel snapshot's
        plane, where that snapshot's gate is open."""
        if self.peel_slot[i] < 0:
            return
        snap_t = self.snaps[int(self.peel_slot[i])][self.tpc]
        dist = plane_dist(self.xs, self.ys, self.zs, snap_t[:, 1:2], snap_t[:, 2:3],
                          snap_t[:, 3:4], snap_t[:, 4:5])
        hit = (
            (snap_t[:, 0:1] > 0.5) & (torch.abs(dist) < f32(self.params.th_dist_v))
        ).to(torch.float32)
        self.active = self.active * (1.0 - hit)

    def lpr_take(self):
        """SEEDFIT: (take, rank, m_t): the eligible rows among the patch's
        lowest num_lpr (exclusive tile prefix + in-tile lane rank), each
        row's rank among the patch's eligible rows, each tile's count."""
        elig = self.active * torch.where(
            self.zone0_t & (self.zs < self.margin_thr), self.zero, self.one)
        e = (elig > 0.5).to(torch.int32)
        m_t = e.sum(dim=1, dtype=torch.int32)
        excl = torch.cumsum(m_t, 0, dtype=torch.int32) - m_t
        prior = excl - excl[self.first]
        quota = torch.clamp_min(self.params.num_lpr - prior, 0)
        rank = _lane_prefix_exclusive(e)
        take = elig * (rank < quota[:, None]).to(torch.float32)
        return take, prior[:, None] + rank, m_t

    def lpr_sums(self, take) -> tuple:
        """(lpr_sum, cnt) per patch of the taken rows (one shard)."""
        per = torch.stack([row_sum(self.zs * take), row_sum(take)], dim=1)
        tot = self.reduce(per, self.idx, self.ok)
        return tot[:, 0], tot[:, 1]

    def lpr_table(self, take, grank, m_t) -> torch.Tensor:
        """(S, 2 num_lpr + 1) the shard's dense LPR candidate table: z at
        each shard rank slot, the slots' occupancy, the eligible count."""
        return self.reduce(torch.cat([
            _lpr_table(self.zs, take, grank, self.params.num_lpr),
            m_t[:, None].to(torch.float32),
        ], dim=1), self.idx, self.ok)

    def seed_mask(self, i: int, lpr_sum, cnt) -> torch.Tensor:
        """SEEDFIT: the seed rows, z under the LPR mean + th, where the gate
        is open."""
        lpr_p = torch.where(cnt > 0, lpr_sum / torch.clamp_min(cnt, 1.0), self.zero)
        return (
            self.active
            * (self.zs < lpr_p[self.tpc][:, None] + float(self.th[i])).to(torch.float32)
            * (self.gate(i)[self.tpc][:, None] > 0.5).to(torch.float32)
        )

    def dist_mask(self, i: int) -> torch.Tensor:
        """FITDIST: the rows under th from the current plane; the final
        pass keeps that plane (carry2)."""
        if self.final[i]:
            self.final_tab = self.plane[:, 0:4]
        pl_t = self.plane[self.tpc, 0:4]
        dist = plane_dist(self.xs, self.ys, self.zs, pl_t[:, 0:1], pl_t[:, 1:2],
                          pl_t[:, 2:3], pl_t[:, 3:4])
        return self.active * (dist < float(self.th[i])).to(torch.float32)

    def moments(self, mask) -> torch.Tensor:
        """(S, 10) per-patch moment sums of the masked rows (one shard)."""
        return self.reduce(_tile_moments(self.xs, self.ys, self.zs, self.sx, self.sy,
                                         self.sz, mask), self.idx, self.ok)

    def end_pass(self, i: int, momp) -> None:
        """The end of pass i from its (merged) moment sums: g_count of the
        final pass, the plane where the gate is open and the sums hold a
        point, the vertical snapshot of a SEEDFIT pass."""
        gate = self.gate(i)
        if self.kind[i] == K_FITDIST and self.final[i]:
            self.g_count = momp[:, 0]
        row = plane_row_from_moments(
            momp, self.gates_p[:, 1], self.gates_p[:, 2], self.gates_p[:, 3]
        )
        upd = (gate > 0.5) & (momp[:, 0] > 0)
        self.plane = torch.where(upd[:, None], row, self.plane)
        if self.kind[i] == K_SEEDFIT and self.snap_slot[i] >= 0:
            vert = (
                (self.alive > 0.5) & self.zone0_p
                & (self.plane[:, 2] < f32(self.params.uprightness_thr))
            ).to(torch.float32)
            self.snaps[int(self.snap_slot[i])] = torch.cat(
                [vert[:, None], self.plane[:, 0:4]], dim=1)
            self.alive = vert

    def table(self) -> torch.Tensor:
        """The (S, out_cols) per-patch result table."""
        plane = self.plane
        spad = plane.shape[0]
        svals = torch.stack(eig3_plane_columns(*plane[:, 5:11].unbind(1), vector=False), dim=1)
        # [normal(3), d, mean(3), n, gcount, cov(6), pad, snaps(5*nsnap),
        #  carry2(4), svals(3), pad]
        out = torch.cat(
            [
                plane[:, 0:4],
                plane[:, 11:14],
                plane[:, 4:5],
                self.g_count[:, None],
                plane[:, 5:11],
                torch.zeros((spad, 1), device=self.dev),
                *self.snaps,
                self.final_tab,
                svals,
                torch.zeros((spad, self.out_cols - (self.carry2_off + 7)), device=self.dev),
            ],
            dim=1,
        )
        assert out.shape == (spad, self.out_cols)
        return out


def tiled_fit(
    xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, margin_thr,
    params: Params, reduce=_reduce_tiles_split3, comm=None,
):
    """Run the fit program on the tiled layout.

    Args:
      xs, ys, zs, valid_f: (NT, 128) f32 tiled point data.
      tile_patch: (NT,) or (NT, 1) int patch owning each tile (sentinels
        clamped to S-1).
      pad_start: (S+1,) int32 tile-aligned run starts (ops/tiled.py).
      gates_p: (S, 8) f32 [processed, shift_x, shift_y, shift_z, zone0, 0..].
      margin_thr: () f32 zone-0 seed margin (margin * sensor_height).
      reduce: the per-tile -> per-patch sum: K1's split-bf16x3 sums
        (default) or K2's plain f32 sums (``_reduce_tiles_f32``).
      comm: a sharded ``pipeline.FrameComm`` (JAX ``ops/tiled_fit.py:
        254-282``, ``:315-319``) or None: its ``merge_lpr_table`` and
        ``reduce_patches`` are the program's only cross-shard movement.
        Under it each SEEDFIT pass builds the shard's dense LPR candidate
        table (slot r: the shard's r-th lowest eligible z of the patch)
        and sums it, like the occupancy and the eligible counts, with
        ``reduce``; every pass's moments go through ``reduce_patches``.
        This is the plain version of the sharded fit kernel KS
        (``ops/sharded_fit.py``).

    Returns:
      (S, out_cols) f32 per-patch result table (fit_kernel OUT_* layout,
      extended by out_layout).
    """
    p = params
    sharded = comm is not None and comm.is_sharded
    prog = FitProgram(xs, ys, zs, valid_f, tile_patch, pad_start, gates_p, margin_thr,
                      p, reduce)
    for i in range(prog.npasses):
        if prog.kind[i] == K_SEEDFIT:
            prog.peel(i)
            take, grank, m_t = prog.lpr_take()
            if sharded:
                loc = prog.lpr_table(take, grank, m_t)
                lpr_sum, cnt = comm.merge_lpr_table(
                    loc[:, :p.num_lpr], loc[:, p.num_lpr:2 * p.num_lpr],
                    loc[:, 2 * p.num_lpr], p.num_lpr,
                )
            else:
                lpr_sum, cnt = prog.lpr_sums(take)
            mask = prog.seed_mask(i, lpr_sum, cnt)
        else:  # K_FITDIST
            mask = prog.dist_mask(i)
        momp = prog.moments(mask)
        if sharded:
            momp = comm.reduce_patches(momp)
        prog.end_pass(i, momp)
    tiled_fit.calls += 1
    return prog.table()


# Calls of the plain program (read by chip_smoke.py: the sharded paths must
# not run it on the card).
tiled_fit.calls = 0
