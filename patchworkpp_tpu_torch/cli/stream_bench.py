"""Streaming-throughput run: one frame per dispatch, the masks fetched a frame late.

The streaming shape of a live feed (port of ``patchworkpp_tpu/cli/
stream_bench.py``): each scan of the six-scan cycle (``cli/workload.py``)
reaches the device frame after frame; the frame step (on the card a captured
frame, ``graphs.py``, as the JAX CLI jits it) runs with the adaptive state
resident on the device; each frame's ground mask is copied back one frame
late, so the copy overlaps the next frame's work. Two loaders:

- ``numpy`` (default): each scan padded once on the host, kept in pinned
  memory on a card and uploaded from there every frame;
- ``native``: the prefetching C++ loader (``io/native_loader.py``) stages
  each scan from its file, padded, on three prefetch threads (the JAX
  CLI's setting); each staged
  buffer is copied into one pinned tensor and uploaded from it. It needs
  the scans as files (``--scan-dir`` or ``$PPK_DATA_DIR``) and raises where
  the loader cannot be built.

Usage: python3 -m patchworkpp_tpu_torch.cli.stream_bench [--epochs 10]
[--capacity 131072] [--loader numpy|native] [--scan-dir DIR]
[--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

from patchworkpp_tpu_torch.cli.workload import (
    DATA_ENV,
    card,
    resolve_device,
    scan_cycle,
    scan_paths,
)


def _numpy_feed(scans, capacity: int, dev, total: int) -> Iterator[Tuple[torch.Tensor, int]]:
    from patchworkpp_tpu_torch.io.kitti import pad_cloud

    host = []
    for s in scans:
        padded, n = pad_cloud(s, capacity)
        t = torch.from_numpy(padded)
        host.append((t.pin_memory() if dev.type == "cuda" else t, int(n)))
    for f in range(total):
        x, n = host[f % len(host)]
        yield x.to(dev, non_blocking=True), n


def _native_feed(paths, capacity: int, dev, total: int) -> Iterator[Tuple[torch.Tensor, int]]:
    from patchworkpp_tpu_torch.io.native_loader import NativeScanLoader

    on_card = dev.type == "cuda"
    staged = torch.empty((capacity, 4), dtype=torch.float32, pin_memory=on_card)
    uploaded = torch.cuda.Event() if on_card else None
    with NativeScanLoader(paths, capacity, queue_depth=4, n_threads=3, loop=True) as ld:
        for f, (view, npts, _) in enumerate(ld):
            if f == total:
                break
            if uploaded is not None:
                uploaded.synchronize()  # the last upload has left `staged`
            staged.copy_(torch.from_numpy(view))
            if on_card:
                x = staged.to(dev, non_blocking=True)
                uploaded.record()
            else:
                x = staged.clone()
            yield x, npts
        if ld.io_errors or ld.truncations:
            raise RuntimeError(f"native loader: {ld.io_errors} unreadable files, "
                               f"{ld.truncations} scans over capacity {capacity}")


def run(dev, capacity: int, epochs: int, loader: str = "numpy", scans=None,
        paths=None) -> Tuple[int, float, List[np.ndarray]]:
    """Stream ``epochs`` passes over the cycle through the frame step on
    ``dev``; ``scans`` (arrays) feed the numpy loader, ``paths`` (files) the
    native one. Returns (frames, seconds, the first epoch's ground masks)."""
    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.graphs import CompiledFrame
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    cycle = len(scans) if loader == "numpy" else len(paths)
    total = epochs * cycle
    params = Params()
    fn = CompiledFrame(make_frame_fn(params, device=dev), params, dev)
    state = init_state(params, dev)
    # warm-up: builds the fit kernel and captures the frame (and builds the
    # native loader, outside the timed loop)
    state, res = fn(state, torch.zeros((capacity, 4), device=dev), 0)
    res.ground_mask.cpu()
    if loader == "native":
        from patchworkpp_tpu_torch.io.native_loader import build

        build()

    feed = (_numpy_feed(scans, capacity, dev, total) if loader == "numpy"
            else _native_feed(paths, capacity, dev, total))
    first: List[np.ndarray] = []
    pending = []

    def fetch():
        mask, n = pending.pop(0)
        mask = mask.cpu()
        if len(first) < cycle:
            first.append(mask.numpy()[:n].copy())

    frames = 0
    t0 = time.perf_counter()
    for x, n in feed:
        state, res = fn(state, x, n)
        pending.append((res.ground_mask, n))
        if len(pending) > 1:
            fetch()
        frames += 1
    while pending:
        fetch()
    return frames, time.perf_counter() - t0, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10, help="passes over the 6 scans")
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--sub", type=int, default=1, metavar="K",
                    help="keep every K-th point of each scan (a small run; numpy loader)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loader", choices=("numpy", "native"), default="numpy")
    ap.add_argument("--scan-dir", default=os.environ.get(DATA_ENV),
                    help=f"directory of 000000.bin .. 000005.bin (default ${DATA_ENV}; "
                         "without it the numpy loader streams the synthetic scans)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.loader == "native":
        if not args.scan_dir:
            raise SystemExit(f"--loader native reads files: pass --scan-dir or set {DATA_ENV}")
        if args.sub > 1:
            raise SystemExit("--loader native stages whole files: --sub must be 1")
        paths = scan_paths(args.scan_dir)
        workload, scans = f"kitti6 ({args.scan_dir})", None
    elif args.scan_dir:
        from patchworkpp_tpu_torch.io.kitti import read_bin

        paths = None
        scans = [read_bin(p)[::args.sub].copy() for p in scan_paths(args.scan_dir)]
        workload = f"kitti6 ({args.scan_dir})"
    else:
        paths = None
        workload, scans = scan_cycle(args.seed, args.sub)

    total, dt, _ = run(dev, args.capacity, args.epochs, args.loader, scans, paths)
    print(f"{workload}: {total} frames in {dt:.2f}s -> {total / dt:.1f} scans/s "
          f"({dt / total * 1e3:.2f} ms/frame) on {card(dev) or dev}, {args.loader} loader")
    return 0


if __name__ == "__main__":
    sys.exit(main())
