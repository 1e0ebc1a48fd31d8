"""Multi-process self-check of the parallel layer (the port's analog of the
JAX package's ``__graft_entry__.dryrun_multichip``).

:func:`spawn` runs a function in N processes joined by a gloo process
group, rendezvousing through a ``file://`` store in a fresh temporary
directory (no TCP port to pick, so concurrent runs cannot clash).
:func:`dryrun_multiproc` uses it: every rank segments the same cloud
through each scaling path and must reproduce the single-process result
exactly, or the run fails:

- point-sharded over all N ranks (tiled and unfused engines) and its
  2-frame sequence (the adapted frame against a single-process chain);
- the shard x chunk composition (N ranks x 2 chunks);
- a 2-D ("frame", "point") split: the ranks in rows of ``n_point``, one
  ``dist.new_group`` per row, each row running its own frame point-sharded
  over its group;
- frame-parallel over all N ranks, one stream each.

Runs every rank on the card by default (their gloo gathers go through the
host) and raises without CUDA; ``device="cpu"`` runs them on the CPU.

Usage: python3 -m patchworkpp_tpu_torch.parallel.selfcheck [--n 4]
[--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(rank, nprocs, init_file, target, args, errors):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=nprocs)
        try:
            target(rank, nprocs, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def spawn(target, nprocs: int, args=(), timeout: float = 300.0) -> None:
    """Run ``target(rank, nprocs, *args)`` in ``nprocs`` spawned processes,
    each in a gloo group of that size (``target`` must be importable by
    module path). Raises RuntimeError when a rank fails or the run outlasts
    ``timeout`` seconds; every process is ended before it returns."""
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="ppk_dist_") as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, init_file, target, args, errors))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    reports = []
    while not errors.empty():
        reports.append("rank %d:\n%s" % errors.get())
    if hung:
        raise RuntimeError(f"ranks {hung} still running after {timeout} s\n"
                           + "\n".join(reports))
    if failed:
        raise RuntimeError(f"ranks failed (rank, exit code): {failed}\n"
                           + "\n".join(reports))


def _cloud(cap: int, n: int) -> np.ndarray:
    """One seeded cloud for every configuration (as the JAX dryrun's):
    a noisy tilted ground ring from 2 to 60 m."""
    rng = np.random.default_rng(1)
    pts = np.zeros((cap, 4), np.float32)
    r = rng.uniform(2.0, 60.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    pts[:n, 0] = r * np.cos(th)
    pts[:n, 1] = r * np.sin(th)
    pts[:n, 2] = rng.normal(-1.7, 0.05, n) + 0.02 * r
    pts[:n, 3] = rng.uniform(0, 1, n)
    return pts


def _dryrun_rank(rank: int, nprocs: int, device: str) -> None:
    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.parallel import (
        batch_init_state,
        make_batch_frame_fn,
        make_point_sharded_frame_fn,
        make_point_sharded_sequence_fn,
        make_sharded_chunked_frame_fn,
    )
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    dev = torch.device(device)
    p = Params()
    n_frame = next(c for c in range(int(nprocs ** 0.5), 0, -1) if nprocs % c == 0)
    n_point = nprocs // n_frame
    cap = 2048 * nprocs
    n = cap - 128
    cloud = torch.from_numpy(_cloud(cap, n)).to(dev)

    def log(msg):
        if rank == 0:
            print(f"[dryrun] {msg}", flush=True)

    ref_fn = make_frame_fn(p, device=dev)
    st_ref, ref = ref_fn(init_state(p, dev), cloud, n)
    _, ref1 = ref_fn(st_ref, cloud, n)
    ref_mask = ref.ground_mask.cpu()
    count = int(ref.num_ground)
    log(f"single-process reference: num_ground={count}")
    if not 0 < count < n:
        raise AssertionError("degenerate reference result")

    def check(name, res, want=ref_mask):
        mism = int((res.ground_mask.cpu() != want).sum())
        if mism or int(res.num_ground) != int(want.sum()):
            raise AssertionError(f"rank {rank}, {name}: {mism} labels differ, "
                                 f"num_ground {int(res.num_ground)} vs {int(want.sum())}")
        log(f"{name}: num_ground={int(res.num_ground)} (exact match)")

    for fused in ("tiled", False):
        fn = make_point_sharded_frame_fn(p, fused=fused, device=dev)
        check(f"point-sharded ({fused or 'unfused'}) x{nprocs}",
              fn(init_state(p, dev), cloud, n)[1])
    check(f"shard-x-chunk {nprocs}x2",
          make_sharded_chunked_frame_fn(p, 2, device=dev)(init_state(p, dev), cloud, n)[1])
    seq = make_point_sharded_sequence_fn(p, device=dev)
    _, res = seq(init_state(p, dev), torch.stack([cloud, cloud]), [n, n])
    check("point-sharded sequence frame 0",
          res._replace(ground_mask=res.ground_mask[0], num_ground=res.num_ground[0]))
    check("point-sharded sequence frame 1 (adapted)",
          res._replace(ground_mask=res.ground_mask[1], num_ground=res.num_ground[1]),
          ref1.ground_mask.cpu())

    # 2-D: rows of n_point ranks, each row one frame point-sharded over its
    # own group (every rank creates every group, in the same order)
    rows = [dist.new_group(list(range(f * n_point, (f + 1) * n_point)))
            for f in range(n_frame)]
    row = rows[rank // n_point]
    fn2 = make_point_sharded_frame_fn(p, group=row, device=dev)
    check(f"2-D split {n_frame}x{n_point}, frame {rank // n_point}",
          fn2(init_state(p, dev), cloud, n)[1])

    batch = make_batch_frame_fn(p, device=dev)
    _, res3 = batch(batch_init_state(p, nprocs, dev),
                    torch.stack([cloud] * nprocs), [n] * nprocs)
    for f in range(nprocs):
        check(f"frame-parallel x{nprocs} stream {f}",
              res3._replace(ground_mask=res3.ground_mask[f], num_ground=res3.num_ground[f]))
    log("all configurations exact vs single-process")


def dryrun_multiproc(n: int, device: str = "cuda", timeout: float = 600.0) -> None:
    """Run the self-check over ``n`` gloo processes; raises on any label
    that differs from the single-process frame (or on a failed or hung
    rank), and without CUDA unless ``device="cpu"``."""
    from patchworkpp_tpu_torch.device import resolve_device

    spawn(_dryrun_rank, n, (str(resolve_device(device)),), timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="processes (ranks)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    dryrun_multiproc(args.n, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
