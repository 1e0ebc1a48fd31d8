"""Point-sharded single-frame execution (port of
``patchworkpp_tpu/parallel/point_sharded.py``), over ``torch.distributed``.

The points of one scan are split in contiguous row blocks across the shards
of a process group; each shard bins, tiles and fits only its rows. The
per-patch statistics (bin counts, the <= num_lpr lowest seed candidates,
plane-fit moments, the ground count) are the only state that crosses
shards. The patch space and the adaptive state stay replicated, so A-GLE,
TGR and the threshold updates are computed identically on every shard.

:class:`MeshComm` holds the reduction arithmetic; a transport moves the
tensors. A transport has one method, ``gather(x) -> (n_shards, *x.shape)``
in linear shard order (outermost axis first, JAX ``_gather_linear``), and
an ``index``, the shard's place in that order:

- :class:`GroupTransport`: the ranks of a process group;
- ``parallel/chunked.py``: the chunk threads of one process, and the
  (rank, chunk) pairs of the shard x chunk composition.

Any two programs over the same row blocks in the same linear order run the
same arithmetic, so they agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from patchworkpp_tpu_torch.device import resolve_device
from patchworkpp_tpu_torch.ops import seq_sum
from patchworkpp_tpu_torch.ops.segments import SortedPoints, segment_rank
from patchworkpp_tpu_torch.params import CZMGeometry, Params
from patchworkpp_tpu_torch.pipeline import FrameComm, make_frame_fn, sequence_of


class MeshComm(FrameComm):
    """The frame's cross-shard hooks over a transport (JAX ``MeshComm``)."""

    is_sharded = True

    def __init__(self, transport) -> None:
        self.transport = transport

    @property
    def eager_only(self) -> str | None:
        """The transport's: None where its gathers are device ops on the
        frame's card (the chunks of one process), else why not."""
        return self.transport.eager_only

    def row_offset(self, n_local: int) -> int:
        return self.transport.index * n_local

    def reduce_patches(self, x: torch.Tensor) -> torch.Tensor:
        """Fixed-order cross-shard sum of a per-patch statistic: the shard
        partials gathered and added left to right, ``g[0] + g[1] + ...``.

        Not an all-reduce, whose float accumulation order is the
        collective's choice: one order everywhere makes the sum the same
        for every transport, topology and run."""
        g = self.transport.gather(x)
        out = g[0]
        for i in range(1, g.shape[0]):
            out = out + g[i]
        return out

    def merge_lpr_table(self, z_at_rank, occ, elig_cnt, num_lpr: int):
        """Global (lpr_sum, lpr_cnt) from every shard's dense LPR table:
        unoccupied slots masked to +inf (they sort to the tail), every
        shard's columns gathered and sorted, the lowest ``num_lpr`` kept,
        the reduced (integer, so exact) eligible counts clamped to
        ``num_lpr``, and the first ``k`` sorted values summed from the
        left, as XLA:CPU sums the JAX package's 20-wide row.

        The addends are the single-device path's and come in ascending z,
        but the association differs from its per-tile-then-patch sums, so a
        sharded LPR mean can differ from the single-device one by an ulp:
        equal labels are an empirical property, held by the tests."""
        inf = torch.full((), float("inf"), dtype=z_at_rank.dtype, device=z_at_rank.device)
        dense = torch.where(occ > 0.5, z_at_rank, inf)
        g = self.transport.gather(dense)  # (n, S, num_lpr)
        allv = g.permute(1, 0, 2).reshape(dense.shape[0], -1)
        merged = torch.sort(allv, dim=1).values[:, :num_lpr]
        k = torch.clamp_max(self.reduce_patches(elig_cnt), float(num_lpr))
        iota = torch.arange(num_lpr, dtype=k.dtype, device=k.device)
        zero = torch.zeros((), dtype=merged.dtype, device=merged.device)
        return seq_sum(torch.where(iota[None, :] < k[:, None], merged, zero)), k

    def lpr_stats(self, sp: SortedPoints, elig: torch.Tensor, num_lpr: int):
        """The unfused engine's hook: the shard's dense table (slot r of a
        patch: its r-th lowest eligible z here; one point a slot, an exact
        selection) and eligible counts, merged as :meth:`merge_lpr_table`."""
        width = sp.start.shape[0] - 1
        rank = segment_rank(elig, sp)
        take = elig & (rank < num_lpr)
        pid = sp.patch_id.to(torch.int64)
        flat = torch.where(take, pid * num_lpr + rank, width * num_lpr)
        z_tab = torch.zeros(width * num_lpr + 1, dtype=sp.z.dtype, device=sp.z.device)
        occ = torch.zeros_like(z_tab)
        z_tab.scatter_(0, flat, sp.z)
        occ.scatter_(0, flat, take.to(occ.dtype))
        cnt = torch.zeros(width, dtype=torch.int32, device=sp.z.device).index_add_(
            0, pid, elig.to(torch.int32))
        return self.merge_lpr_table(
            z_tab[:-1].reshape(width, num_lpr), occ[:-1].reshape(width, num_lpr),
            cnt.to(torch.float32), num_lpr,
        )


class GroupTransport:
    """``gather`` over the ranks of a ``torch.distributed`` process group
    (default WORLD), in group-rank order.

    A gloo group moves host tensors only, so a CUDA tensor is copied to the
    host, gathered there and copied back: two ranks on one card (NCCL
    refuses a second rank on a card) exchange their statistics so. An NCCL
    group gathers on the card."""

    # a frame over a process group runs eagerly: gloo gathers through the
    # host, and an NCCL group's gathers reach other cards and processes
    eager_only = ("a process group's gathers cross processes (gloo through the host), so "
                  "a frame over a process group runs eagerly")

    def __init__(self, group=None) -> None:
        self.group = group if group is not None else dist.group.WORLD
        self.index = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.via_host = dist.get_backend(self.group) == "gloo"

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        src = (x.cpu() if self.via_host else x).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(x.device)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along its first axis, in rank
        order (the rank-sharded rows of a result, made whole)."""
        if x.dtype == torch.bool:
            return self.gather_rows(x.to(torch.uint8)).bool()
        return self.gather(x).reshape(-1, *x.shape[1:])


def rank_rows(points: torch.Tensor, transport: GroupTransport, what: str) -> torch.Tensor:
    """This rank's contiguous block of the rows of ``points``."""
    rows = points.shape[0]
    if rows % transport.size:
        raise ValueError(
            f"{what} {rows} not divisible by the group size {transport.size}"
        )
    r = rows // transport.size
    return points[transport.index * r:(transport.index + 1) * r]


def build(
    params: Params,
    group=None,
    fused="tiled",
    geom: CZMGeometry | None = None,
    device="cuda",
):
    """The point-sharded frame step over the ranks of ``group`` (default
    WORLD): ``fn(state, points, npts) -> (state, FrameResult)``.

    Every rank calls it with the same arguments, the whole (P, 4) cloud
    (P divisible by the group size) and the global ``npts``, and works on
    its own block of rows. The state and every per-patch output are
    replicated; the ground mask is gathered from the ranks, so each rank
    returns the whole result, which equals the chunked frame's at
    K = group size bit for bit.

    ``fused``: "tiled" (default; the fit program with the comm's hooks
    between its passes: the kernel KS on the card, ``ops/sharded_fit.py``,
    ``ops/tiled_fit.py`` on the CPU) or False (the unfused
    engine). A group of one rank gives the plain frame with the identity
    comm, with this engine selection, so the default runs K1 on the card
    (JAX ``_comm_for`` and ``_single_device``)."""
    dev = resolve_device(device)
    geom = geom or CZMGeometry.create(params)
    transport = GroupTransport(group)
    if transport.size == 1:
        return make_frame_fn(params, geom, dev, fused)
    frame = make_frame_fn(params, geom, dev, fused, comm=MeshComm(transport))

    def fn(state, points: torch.Tensor, npts: int):
        state, res = frame(state, rank_rows(points, transport, "point capacity"), npts)
        return state, res._replace(ground_mask=transport.gather_rows(res.ground_mask))

    return fn


def build_sequence(
    params: Params,
    group=None,
    fused="tiled",
    geom: CZMGeometry | None = None,
    device="cuda",
):
    """The point-sharded sequence: ``fn(state, stack, npts) -> (state,
    FrameResult)`` over a (B, P, 4) stack, the frame of :func:`build` in
    order with the state threaded through, every field stacked on a leading
    B axis (equal to calling the frame B times, bit for bit)."""
    return sequence_of(build(params, group, fused, geom, device))

