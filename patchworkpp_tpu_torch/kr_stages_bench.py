"""Splits a call of the per-patch sum kernel KR (csrc/patch_reduce.cu) into
its steps on the card, by timing stage builds of the same source.

Builds (each a file in build/ that defines the source's switches and
includes it):

  release     the kernel as shipped (PPK_KR_STAGES 3)
  no_pdl      the fold as a plain launch, not a programmatic dependent
  s0          both launches, returning at once (PPK_KR_STAGES 0)
  s0_no_pdl   the same without the programmatic dependence
  s1          + the chunk map in both launches
  s2          + the chunk sums (launch 1 whole), no fold
  clocks      release, its fold recording each patch's clock64() cycles
              (PPK_KR_CLOCKS): the map, the wait for launch 1, the
              staging, the adds

Inputs: the KR calls of one unfused frame of the synthetic main scan and
of the crowded-patch cloud (io/synthetic.py), recorded by
chip_smoke.record_patch_reduce: the generic mode on the first moment sum
as its 10-column table and on the first LPR sum (2 columns), the moment
mode on the same moment sum's columns, and the generic mode on the crowded
cloud's table. release and no_pdl are first held bit for bit against the
plain version on every recorded call. Each build is then timed with
chip_smoke.cuda_ms (device ms a call, calls queued behind a device sleep),
builds in order and then reversed, three rounds; the differences of the
medians are the steps' costs. Last, a torch.profiler trace of 50 calls of
release and of no_pdl on the 10-column table, queued behind a device sleep,
gives each kernel's traced duration and where the fold starts against
launch 1's end, and the clocks build's records of one call give the fold's
cycles for the longest patch and, fitted over every patch, per chunk.
Needs one CUDA card and nvcc; prints its
whole record as one JSON line last.

Usage, from the repo root: python3 -m patchworkpp_tpu_torch.kr_stages_bench
"""

from __future__ import annotations

import ctypes
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from patchworkpp_tpu_torch import Params
from patchworkpp_tpu_torch.cli.workload import card
from patchworkpp_tpu_torch.io import synthetic
from patchworkpp_tpu_torch.ops import nvcc
from patchworkpp_tpu_torch.ops import patch_reduce_kernel as kr
from patchworkpp_tpu_torch.ops.moments import masked_moment_features_cols
from patchworkpp_tpu_torch.ops.onehot import patch_reduce_reference
from patchworkpp_tpu_torch.utils.roofline import trace

BUILDS = {
    "release": (),
    "no_pdl": ("PPK_KR_NO_PDL",),
    "s0": ("PPK_KR_STAGES 0",),
    "s0_no_pdl": ("PPK_KR_STAGES 0", "PPK_KR_NO_PDL"),
    "s1": ("PPK_KR_STAGES 1",),
    "s2": ("PPK_KR_STAGES 2",),
}
CLOCKS = ("PPK_KR_CLOCKS",)
CLOCK_COLS = ("map", "wait", "staging", "adds", "whole", "chunks")
ROUNDS = 3
TRACED_CALLS = 50
TRACE_SLEEP_S = 0.05  # longer than the traced calls' host time


def build_stage(name: str, defines):
    """KR built with ``defines`` ahead of the source, beside the others."""
    digest = hashlib.sha256(kr.SOURCE.read_bytes()).hexdigest()[:12]
    nvcc.BUILD_DIR.mkdir(exist_ok=True)
    wrapper = nvcc.BUILD_DIR / f"patch_reduce_{name}_{digest}.cu"
    wrapper.write_text(f"// KR stage build {name}, source {digest}\n"
                       + "".join(f"#define {d}\n" for d in defines)
                       + f'#include "{kr.SOURCE}"\n')
    return kr.build_from(wrapper)


def using(lib, fn):
    """``fn()`` with KR's wrappers launching ``lib``."""
    built = kr.build
    kr.build = lambda: lib
    try:
        return fn()
    finally:
        kr.build = built


def check(lib, calls, label):
    """Both modes bit for bit against the plain version on every call."""
    for i, (mode, (a, pid, start)) in enumerate(calls):
        feats = masked_moment_features_cols(*a) if mode == "moments" else a
        want = patch_reduce_reference(feats, pid, start)
        outs = [using(lib, lambda: kr.patch_reduce_kernel(feats, start))]
        if mode == "moments":
            outs.append(using(lib, lambda: kr.patch_moment_sums_kernel(*a, start)))
        for out in outs:
            if not cs.bitwise(out.cpu(), want.cpu()):
                raise AssertionError(f"KR {label}, call {i} ({mode}): not bit for bit")


def traced(lib, feats, start):
    """Each kernel's mean traced us over TRACED_CALLS calls queued behind a
    device sleep (so that they run back to back, as in a captured frame),
    and the fold's start against launch 1's end (us; negative: it
    overlaps)."""
    using(lib, lambda: kr.patch_reduce_kernel(feats, start))

    def run():
        torch.cuda._sleep(int(TRACE_SLEEP_S * cs.SLEEP_CYCLES_PER_S))
        for _ in range(TRACED_CALLS):
            using(lib, lambda: kr.patch_reduce_kernel(feats, start))

    events, _ = trace(run)
    mine = sorted((e for e in events if e.on_device and not e.annotation
                   and any(n in e.name for n in ("kr_chunk_sums", "kr_fold"))),
                  key=lambda e: e.start_us)
    first = [e for e in mine if "kr_chunk_sums" in e.name]
    fold = [e for e in mine if "kr_fold" in e.name]
    if len(first) != TRACED_CALLS or len(fold) != TRACED_CALLS:
        raise AssertionError(f"trace: {len(first)} chunk launches, {len(fold)} folds")
    return {"kr_chunk_sums_us": float(np.mean([e.dur_us for e in first])),
            "kr_fold_us": float(np.mean([e.dur_us for e in fold])),
            "fold_start_after_launch1_end_us": float(np.mean(
                [f.start_us - (a.start_us + a.dur_us) for a, f in zip(first, fold)])),
            "call_span_us": float(np.mean(
                [f.start_us + f.dur_us - a.start_us for a, f in zip(first, fold)]))}


def clock_rows(lib, fn, patches):
    """The clocks build's fold records of one call of ``fn``, the second of
    two queued behind a device sleep (so that it runs right after the
    first, as calls do in a captured frame): (patches, CLOCK_COLS) int64."""
    lib.ppk_kr_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ppk_kr_clocks.restype = ctypes.c_int
    using(lib, fn)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(TRACE_SLEEP_S * cs.SLEEP_CYCLES_PER_S))
    using(lib, fn)
    using(lib, fn)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (len(CLOCK_COLS) * patches))()
    rc = lib.ppk_kr_clocks(ctypes.cast(buf, ctypes.c_void_p), patches)
    if rc != 0:
        raise RuntimeError(f"ppk_kr_clocks: CUDA error {rc}")
    return np.frombuffer(buf, dtype=np.int64).reshape(patches, len(CLOCK_COLS)).copy()


def clock_report(rows) -> dict:
    """The longest patch's cycles by step, and each step's cycles per chunk
    fitted over the patches that have chunks (least squares, with an
    intercept)."""
    cols = dict(zip(CLOCK_COLS, rows.T))
    longest = int(np.argmax(cols["chunks"]))
    has = cols["chunks"] > 0
    return {"longest_patch": {k: int(v[longest]) for k, v in cols.items()},
            "cycles_per_chunk": {k: float(np.polyfit(cols["chunks"][has], cols[k][has], 1)[0])
                                 for k in ("staging", "adds", "whole")}}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kr_stages_bench needs a CUDA card")
    where = card(torch.device("cuda"))
    print(where)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        futs = {k: pool.submit(build_stage, k, d)
                for k, d in {**BUILDS, "clocks": CLOCKS}.items()}
        libs = {k: f.result() for k, f in futs.items()}
    p = Params()
    main_calls = cs.record_patch_reduce(p, synthetic.make_scan(0))
    crowd_calls = cs.record_patch_reduce(p, synthetic.make_crowded_scan(0))
    for k in ("release", "no_pdl", "clocks"):
        check(libs[k], main_calls, f"{k}, main scan")
        check(libs[k], crowd_calls, f"{k}, crowded cloud")
    print("release, no_pdl and clocks builds == the plain version bit for bit on every "
          "recorded call of the main scan and the crowded cloud, both modes")

    mom = next(c for c in main_calls if c[0] == "moments")
    feats, _, start = cs.kr_table(mom)
    lpr, _, l_start = cs.kr_table(next(c for c in main_calls if c[0] == "reduce"))
    c_feats, _, c_start = cs.kr_table(next(c for c in crowd_calls if c[0] == "moments"))
    inputs = {
        "generic, 10-column table": lambda: kr.patch_reduce_kernel(feats, start),
        "generic, LPR sum (2 columns)": lambda: kr.patch_reduce_kernel(lpr, l_start),
        "moment mode": lambda: kr.patch_moment_sums_kernel(*mom[1][0], start),
        "generic, crowded 10-column table": lambda: kr.patch_reduce_kernel(c_feats, c_start),
    }
    order = list(BUILDS)
    times = {i: {k: [] for k in order} for i in inputs}
    for _ in range(ROUNDS):
        for k in order + order[::-1]:
            for i, fn in inputs.items():
                times[i][k].append(cs.cuda_ms(lambda: using(libs[k], fn), reps=200,
                                              warmup=5))
    out = {"card": where, "us": {}, "steps_us": {}}
    for i, by in times.items():
        med = {k: float(np.median(v)) * 1e3 for k, v in by.items()}
        out["us"][i] = {k: {"median": med[k], "min": min(by[k]) * 1e3, "max": max(by[k]) * 1e3}
                        for k in order}
        steps = {"two launches doing nothing": med["s0"],
                 "the same without PDL": med["s0_no_pdl"],
                 "+ chunk map": med["s1"] - med["s0"],
                 "+ chunk sums": med["s2"] - med["s1"],
                 "+ fold": med["release"] - med["s2"],
                 "release": med["release"],
                 "no PDL - release": med["no_pdl"] - med["release"]}
        out["steps_us"][i] = steps
        print(f"{i}: " + ", ".join(f"{k} {v:.3f} us" for k, v in steps.items())
              + f" (medians of {2 * ROUNDS}; {where})")
    out["fold_clocks"] = {i: clock_report(clock_rows(libs["clocks"], fn, start.shape[0] - 1))
                          for i, fn in inputs.items()}
    for i, r in out["fold_clocks"].items():
        print(f"fold clocks, {i}: longest patch {r['longest_patch']} (cycles), per chunk "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["cycles_per_chunk"].items())
              + f" cycles; {where}")
    out["trace_us"] = {k: traced(libs[k], feats, start) for k in ("release", "no_pdl")}
    for k, t in out["trace_us"].items():
        print(f"trace of {TRACED_CALLS} queued calls, {k}, 10-column table: "
              + ", ".join(f"{n} {v:.3f}" for n, v in t.items()) + f"; {where}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
