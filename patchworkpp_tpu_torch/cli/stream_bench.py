"""Streaming-throughput run: one frame per dispatch, the masks fetched a frame late.

The streaming shape of a live feed (port of ``patchworkpp_tpu/cli/
stream_bench.py``, without its native prefetch loader): each scan of the
six-scan cycle (``cli/workload.py``) is padded once on the host, kept in
pinned memory on a card, and uploaded frame after frame; the frame step runs
with the adaptive state resident on the device; each frame's ground mask is
copied back one frame late, so the copy overlaps the next frame's work.

Usage: python3 -m patchworkpp_tpu_torch.cli.stream_bench [--epochs 10]
[--capacity 131072] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from patchworkpp_tpu_torch.cli.workload import card, resolve_device, scan_cycle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10, help="passes over the 6 scans")
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--sub", type=int, default=1, metavar="K",
                    help="keep every K-th point of each scan (a small run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.io.kitti import pad_cloud
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    dev = resolve_device(args.device)
    workload, scans = scan_cycle(args.seed, args.sub)
    host = []
    for s in scans:
        padded, n = pad_cloud(s, args.capacity)
        t = torch.from_numpy(padded)
        host.append((t.pin_memory() if dev.type == "cuda" else t, int(n)))

    params = Params()
    fn = make_frame_fn(params, device=dev)
    state = init_state(params, dev)
    # warm-up: builds the fit kernel
    state, res = fn(state, torch.zeros((args.capacity, 4), device=dev), 0)
    res.ground_mask.cpu()

    total = args.epochs * len(host)
    pending = []
    t0 = time.perf_counter()
    for f in range(total):
        x, n = host[f % len(host)]
        state, res = fn(state, x.to(dev, non_blocking=True), n)
        pending.append(res.ground_mask)
        if len(pending) > 1:
            pending.pop(0).cpu()
    while pending:
        pending.pop(0).cpu()
    dt = time.perf_counter() - t0
    print(f"{workload}: {total} frames in {dt:.2f}s -> {total / dt:.1f} scans/s "
          f"({dt / total * 1e3:.2f} ms/frame) on {card(dev) or dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
