"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the cards
the cell asks for. It makes the cell's drive from the seed, builds the
program (``patchworkpp_tpu_torch``, through its public entry points), warms
it up, runs the traffic mix closed loop for the window's seconds, then
checks the kept outputs against the plain reference and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones, read from a profiler trace of a slice of the window),
``device``, with ``--trace 1`` ``breakdown``, ``phases`` (the seconds of
set-up, with the seconds from the start at which its steps ended, window
and check), and last ``checks``, each number compared beside its limit
(also the last lines of standard error).

Exits non-zero without a result when CUDA or the cards are missing, when
the program is not beside the benchmark, or when JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import manifest as mf  # noqa: E402
from benchmark.check import compare, judge  # noqa: E402
from benchmark.drivers import ENTRIES, RunRecord  # noqa: E402
from benchmark.peaks import k1_least_seconds  # noqa: E402
from benchmark.reference.oracle import Reference  # noqa: E402
from benchmark.reference.params import Params as RefParams  # noqa: E402
from benchmark.scans import make_drive  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "patchworkpp_tpu")
PROGRAM = "patchworkpp_tpu_torch"
# kept inside the checkout at fixed paths, so that only a cell's first run
# in a checkout builds or compiles anything (the port's own nvcc builds go
# to patchworkpp_tpu_torch/build/, also inside the checkout)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "nv"}


def forbidden_modules():
    """Top-level names, compared whole, of loaded modules that the run may
    not load: the port's name begins with the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def mean_k1_least_seconds(params: RefParams, cycle) -> float:
    """K1's least time a launch, on average over the cycle (which the
    traced slice holds whole), from the reference's binning at the
    configured sensor height."""
    ref = Reference(params)
    out = []
    for scan in cycle:
        ids = ref.patch_ids(scan)
        counts = np.bincount(ids[ids >= 0], minlength=params.num_patches)
        out.append(k1_least_seconds(counts, params))
    return float(np.mean(out))


def run_cell(root: Path, manifest: dict, workload_name: str, seed: int, seconds: float,
             traced: bool, device: str, t_origin: float, cfg: Optional[dict] = None,
             mix: Optional[dict] = None, sub: int = 1) -> dict:
    """One run of one cell on ``device``; the result's object. ``cfg``,
    ``mix`` and ``sub`` replace the configuration and the traffic mix and
    thin the scans (the tests' small runs on the CPU)."""
    import torch

    from benchmark.system import Port

    cell = mf.workload(manifest, workload_name)
    cfg = cfg or mf.config(manifest, root, cell["config"])
    mix = mix or mf.traffic(cell["traffic"])
    limits = mf.limits(workload_name)
    on_card = device.startswith("cuda")

    rec = RunRecord()
    rec.setup_marks["imported"] = time.perf_counter() - t_origin
    cycle = make_drive(seed, mix["cycle"], cfg["sensor"], sub)
    rec.setup_marks["scans"] = time.perf_counter() - t_origin
    sut = Port(cfg, device)
    tracer = Tracer() if traced else None
    if tracer is not None:
        tracer.warm()
        rec.setup_marks["profiler"] = time.perf_counter() - t_origin
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kept = ENTRIES[mix["entry"]](sut, cycle, mix, seconds, seed, tracer, rec, t_origin)
    if on_card:
        torch.cuda.synchronize()
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ref_params = RefParams.from_overrides(cfg["params"])
    if tracer is not None:
        rec.trace = tracer.record
        rec.k1_least_s = mean_k1_least_seconds(ref_params, cycle)
    t_check = time.perf_counter()
    numbers = compare(ref_params, cycle, kept)
    check_s = time.perf_counter() - t_check
    correct, checks = judge(numbers, limits, rec.failed, kept.complete(mix["check"]))

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": mf.read_metrics(manifest, workload_name, traced, rec),
              "device": dev}
    if traced and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown
    result["phases"] = {"setup_s": rec.setup_s, "setup_marks": rec.setup_marks,
                        "window_s": rec.window_s, "check_s": check_s, "scans": rec.scans}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    manifest = mf.load_manifest(root)
    cell = mf.workload(manifest, args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program ({PROGRAM}) is not in {root}", file=sys.stderr)
        return 2
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / ".bench_cache" / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    result = run_cell(root, manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_ORIGIN)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the run may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
