"""Multi-stream demo: LiDAR feeds multiplexed through one engine (port of
``patchworkpp_tpu/cli/demo_multi_stream.py``).

New capability over the reference (its ROS node serves exactly one topic per
process, ros/src/GroundSegmentationServer.cpp): N streams share one engine,
each with its own adaptive state on the device. Stream s starts s scans into
the sequence, so each has its own adaptive history. The scans are those of
``demo_sequential``: the ``.bin`` files of ``data_dir`` (default
``$PPK_DATA_DIR``), else the six synthetic 64-beam scans.

Usage: python3 -m patchworkpp_tpu_torch.cli.demo_multi_stream [data_dir]
[--streams N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from patchworkpp_tpu_torch.cli.demo_sequential import named_scans
from patchworkpp_tpu_torch.cli.workload import DATA_ENV, resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?", default=os.environ.get(DATA_ENV))
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--sub", type=int, default=1, metavar="K",
                    help="keep every K-th point of each scan (a small run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from patchworkpp_tpu_torch.serve import MultiStreamSegmenter

    feed = list(named_scans(args.data_dir, args.seed, args.sub))
    ms = MultiStreamSegmenter(capacity=args.capacity, device=str(resolve_device(args.device)))
    for step in range(len(feed)):
        for s in range(args.streams):
            name, cloud = feed[(step + s) % len(feed)]
            t0 = time.perf_counter()
            res = ms.segment(f"stream{s}", cloud)
            dt = 1e3 * (time.perf_counter() - t0)
            print(
                f"step {step} stream{s} ({name}): {len(cloud)} pts -> "
                f"{int(res.ground_mask.sum())} ground  ({dt:.1f} ms, "
                f"sensor_height={ms.sensor_height(f'stream{s}'):.4f})"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
