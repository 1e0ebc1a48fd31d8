#!/usr/bin/env python3
"""The correctness check's numbers of a drive cell's start chain over many
seeds: for each seed, the port's ``estimate_ground_sequence`` over the
cell's 24-scan cycle from the fresh state, then ``benchmark.check.compare``
on those outputs and the state after them (the only state a drive mix
compares), and for the first ``--control`` seeds the control's numbers.
The reference runs in worker processes while the card runs the next seeds.

Usage (one CUDA card; the reference's work takes the host's cores):
    python3 scripts/check_sweep.py --config ros_launch_hdl64 --first-seed 2718281828 \\
        --seeds 110 --control 8 --seconds 480 --out chiprun_out/sweep.jsonl

One JSON line a seed in ``--out`` (seed, the change's numbers, the
control's, the counter ``frame.inherited_planes`` a scan), then the
largest, 99th percentile and median of each number on standard output.
Seeds are ``first + 7919 * i``; ``--seconds`` stops the collection.
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import manifest as mf  # noqa: E402
from benchmark.scans import make_drive  # noqa: E402

CYCLE = 24


def _config(name: str) -> dict:
    return mf.config(mf.load_manifest(ROOT), ROOT, name)


def _reference_numbers(args) -> dict:
    """The check's numbers of one seed (run in a worker process)."""
    from benchmark.check import compare, control
    from benchmark.drivers import Kept, Output
    from benchmark.reference.params import Params

    name, seed, sub, outs, state, with_control = args
    cfg = _config(name)
    params = Params.from_overrides(cfg["params"])
    cycle = make_drive(seed, CYCLE, cfg["sensor"], sub)
    kept = Kept(start=[Output(*o) for o in outs], start_state=state)
    row = {"seed": seed, "change": compare(params, cycle, kept)}
    if with_control:
        row["control"] = control(params, cycle, CYCLE)
    return row


def _state(m) -> dict:
    buf = io.BytesIO()
    m.save_state(buf)
    buf.seek(0)
    with np.load(buf) as d:
        return {k: d[k] for k in d.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=1e9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sub", type=int, default=1,
                    help="keep every sub-th point (with capacity 8192: a small run on the CPU)")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    from benchmark.system import Port
    from patchworkpp_tpu_torch.utils import profiling

    cfg = _config(args.config)
    if args.sub > 1:
        cfg["capacity"] = 8192
    m = Port(cfg, args.device).facade()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t0 = time.time()
    ex = ProcessPoolExecutor(max(1, (os.cpu_count() or 2) - 1), mp_context=mp.get_context("spawn"))
    jobs = []
    for i, seed in enumerate(seeds):
        before = profiling.counters().get("frame.inherited_planes")
        m.reset()
        res = m.estimate_ground_sequence(make_drive(seed, CYCLE, cfg["sensor"], args.sub))
        after = profiling.counters().get("frame.inherited_planes")
        inherited = ((after.n if after else 0) - (before.n if before else 0)) / CYCLE
        outs = [(r.ground_mask, r.centers, r.normals) for r in res]
        job = ex.submit(_reference_numbers,
                        (args.config, seed, args.sub, outs, _state(m), i < args.control))
        jobs.append((job, inherited))
    rows = []
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for job, inherited in jobs:
            left = t0 + args.seconds - time.time()
            if left <= 0:
                break
            try:
                row = job.result(timeout=left)
            except TimeoutError:
                break
            row["inherited_per_scan"] = inherited
            rows.append(row)
            f.write(json.dumps(row) + "\n")
    ex.shutdown(wait=False, cancel_futures=True)
    print(f"{len(rows)} seeds in {time.time() - t0:.0f} s")
    for key in ("label_mismatch", "plane_mismatch", "height_gap", "flatness_gap", "buffer_gap"):
        v = np.array([r["change"][key] for r in rows])
        line = (f"{key}: largest {v.max():.3g}, 99th pct {np.quantile(v, 0.99):.3g}, "
                f"median {np.median(v):.3g}")
        ctl = [r["control"][key] for r in rows if "control" in r]
        if ctl:
            line += f"; control least {min(ctl):.3g}, largest {max(ctl):.3g}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
