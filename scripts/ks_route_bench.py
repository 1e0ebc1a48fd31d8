#!/usr/bin/env python3
"""The sharded fit KS on the card: its time on a chunks=2 frame, by route.

Runs the port of the checkout this script sits in (the directory above
``scripts/``), so two trees compare in one call by running each tree's copy
in turn (parent, change, change, parent). On ``make_scan(SEED, 0..2)`` at
capacity 131072, it prints the card's name and power limit and, last, one
JSON line with:

- ``ks_phases_ms``: KS's phase route, the 12 launches of each chunk of a
  chunks=2 frame replayed back to back on their recorded inputs (the sum
  of the two chunks' times, CUDA events);
- ``ks_cluster_ms``: KS's cluster route, both chunks in one launch (absent
  where the tree has no such route);
- ``stage_ms``: the fit stage of a chunks=2 frame as the frame runs it (the
  tree's default route, the chunks' meetings included, CUDA events);
- ``launches_per_frame``: KS launches of that frame for both chunks;
- ``chunked_frame_ms``: the median ``make_chunked_frame_fn(p, 2)`` frame
  (CUDA events) over the three scans, after a warm-up frame (a replay of
  its captured graph, in a tree whose chunked frame is compiled);
- ``two_rank_frame_ms``: the median point-sharded frame of two gloo ranks
  on this card (host clock, rank 0; ``chip_smoke.py``'s rank worker);
- ``k1_ms``, ``k2_ms``: the fit kernels on the main scan's tiled inputs;
- ``ptxas``: registers, spills and shared memory of every kernel built.

Usage: python3 scripts/ks_route_bench.py
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
FRAMES = 3


def ptxas(log: str) -> dict:
    """{kernel entry: 'registers, spills, smem'} from nvcc's -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(fit_\w+?kernel)", name)
            name = short.group(1) if short else name
        elif name and ("spill" in line or "registers" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ks_route_bench: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.ops import fit_kernel as fk
    from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
    from patchworkpp_tpu_torch.ops import sharded_fit as sf
    from patchworkpp_tpu_torch.parallel import make_chunked_frame_fn
    from patchworkpp_tpu_torch.parallel.chunked import _chunk_fit_tables
    from patchworkpp_tpu_torch.parallel.selfcheck import spawn
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    dev = torch.device("cuda")
    with ThreadPoolExecutor(3) as pool:
        for fut in [pool.submit(m.build) for m in (fkg, fk, sf)]:
            fut.result()
    out = {"tree": str(ROOT), "ptxas": {}}
    for m in (fkg, fk, sf):
        out["ptxas"].update(ptxas(m.build_log()))

    p = Params()
    scans = [make_scan(SEED, f) for f in range(FRAMES)]
    xs = []
    for s in scans:
        x = torch.zeros((cs.CAPACITY, 4), device=dev)
        x[: len(s)] = torch.from_numpy(s).to(dev)
        xs.append(x)

    def recorded(fi, comm):
        rec = cs.PhaseRecorder(sf._Kernel(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start,
                                          fi.gates, fi.consts, p))
        sf._drive(rec, p, comm)
        return fi, rec

    recs = [r[0] for r in _chunk_fit_tables(p, 2, xs[0], len(scans[0]), [recorded],
                                            device=dev)]
    out["ks_phases_ms"] = sum(cs.cuda_ms(lambda fi=fi, rec=rec: rec.replay(sf._Kernel(
        fi.xs, fi.ys, fi.zs, fi.valid_f, fi.pad_start, fi.gates, fi.consts, p)), reps=50)
        for fi, rec in recs)
    if hasattr(sf, "cluster_fit"):
        chunks = [(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
                   fi.consts) for fi, _ in recs]
        out["ks_cluster_ms"] = cs.cuda_ms(lambda: sf.cluster_fit(chunks, p), reps=50)

    def default_fit(fi, comm):
        return sf.sharded_fit(fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start,
                              fi.gates, fi.consts, p, comm)

    out["stage_ms"] = cs.sharded_stage_ms(p, scans[0], default_fit, reps=20)
    fn = make_chunked_frame_fn(p, 2, device=dev)
    fn(init_state(p, dev), xs[0], len(scans[0]))  # warm-up
    st, ms = init_state(p, dev), []
    before = sf.sharded_fit.launches
    for x, s in zip(xs, scans):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        st, _ = fn(st, x, len(s))
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out["launches_per_frame"] = (sf.sharded_fit.launches - before) / FRAMES
    out["chunked_frame_ms"] = float(np.median(ms))
    out["chunked_frame_ms_each"] = ms
    with tempfile.TemporaryDirectory(prefix="ppk_ks_") as tmp:
        spawn(cs._multi_device_rank, 2, ({"seed": SEED, "out": tmp, "device": "cuda"},),
              timeout=cs.MULTI_TIMEOUT)
        rank0 = dict(np.load(os.path.join(tmp, "rank0.npz")))
    out["two_rank_frame_ms"] = float(np.median(rank0["ps_host_ms"]))
    out["two_rank_launches"] = rank0["ps_launches"].tolist()

    fi = make_frame_fn(p, device=dev).fit_inputs(init_state(p, dev), xs[0], len(scans[0]))
    args = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
            fi.consts)
    out["k1_ms"] = cs.cuda_ms(lambda: fkg.fused_fit_grid(*args, p), reps=50)
    out["k2_ms"] = cs.cuda_ms(lambda: fk.fused_fit(*args, p), reps=50)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
