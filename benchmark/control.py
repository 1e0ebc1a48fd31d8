"""The control of the correctness check: the reference computed in
bfloat16 (the precision below the configuration's float32) in the
program's place, over the frames a run's check follows from the fresh
state. Its numbers have to fail the cell's limits; the benchmark's own
runs never run it.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3

prints one JSON line a seed with the numbers and whether the limits caught
them, at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from benchmark import manifest as mf
from benchmark.check import control, judge
from benchmark.reference.params import Params
from benchmark.scans import make_drive


def control_numbers(root: Path, workload_name: str, seed: int, sub: int = 1) -> dict:
    man = mf.load_manifest(root)
    cell = mf.workload(man, workload_name)
    cfg = mf.config(man, root, cell["config"])
    mix = mf.traffic(cell["traffic"])
    frames = mix["check"]["start_scans"]
    cycle = make_drive(seed, mix["cycle"], cfg["sensor"], sub)
    numbers = control(Params.from_overrides(cfg["params"]), cycle, frames)
    correct, shown = judge(numbers, mf.limits(workload_name), failed=0, complete=True)
    return {"workload": workload_name, "seed": seed, "sub": sub, "frames": frames,
            "correct": correct, "checks": shown}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    caught = True
    for seed in args.seeds:
        out = control_numbers(Path.cwd(), args.workload, seed)
        caught &= not out["correct"]
        print(json.dumps(out), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
