"""Times the fit kernel K1 (csrc/fit_grid.cu) as built against the same
kernel with every patch staged into shared memory chunk by chunk at every
walk (the path csrc/fit_program.cuh takes only for patches over kCapTiles),
on the synthetic main scan, one-tile and crowded-patch clouds
(io/synthetic.py).

Both builds are first held bit for bit against the plain version; then each
is timed with chip_smoke.cuda_ms (device time, calls queued behind a device
sleep) in the order A B B A, three rounds. Needs one CUDA card and nvcc.

Usage, from the repo root: python3 -m patchworkpp_tpu_torch.k1_rows_bench
"""

from __future__ import annotations

import shutil

import numpy as np
import torch

import chip_smoke as cs
from patchworkpp_tpu_torch import Params, init_state
from patchworkpp_tpu_torch.cli.workload import card
from patchworkpp_tpu_torch.io import synthetic
from patchworkpp_tpu_torch.ops import fit_kernel_grid as fkg
from patchworkpp_tpu_torch.ops import nvcc
from patchworkpp_tpu_torch.ops.tiled_fit import tiled_fit
from patchworkpp_tpu_torch.pipeline import make_frame_fn

SMEM_TEST = "const bool resident = T <= kCapTiles;"


def build_global_only():
    """K1 with no patch resident in shared memory, built beside the others."""
    out = nvcc.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (nvcc.CSRC / "fit_program.cuh").read_text()
    if SMEM_TEST not in src:
        raise RuntimeError(f"fit_program.cuh no longer holds {SMEM_TEST!r}")
    (out / "fit_program.cuh").write_text(src.replace(SMEM_TEST, "const bool resident = false;"))
    for name in ("fit_grid.cu", "fit_math.cuh"):
        shutil.copy(nvcc.CSRC / name, out / name)
    return nvcc.build(out / "fit_grid.cu", "ppk_fit_grid", fkg.ARGTYPES)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_rows_bench needs a CUDA card")
    dev, p = torch.device("cuda"), Params()
    print(card(dev))
    libs = {"A": fkg.build(), "B": build_global_only()}
    built = fkg.build

    def run(which, a):
        fkg.build = lambda: libs[which]
        try:
            return fkg.fused_fit_grid(*a, p)
        finally:
            fkg.build = built

    for name, cloud in (("main scan", synthetic.make_scan(0)),
                        ("one-tile", synthetic.make_one_tile_scan(0)),
                        ("crowded", synthetic.make_crowded_scan(0))):
        x = torch.zeros((synthetic.CAPACITY, 4), device=dev)
        x[: len(cloud)] = torch.from_numpy(cloud).to(dev)
        fi = make_frame_fn(p, device=dev).fit_inputs(init_state(p, dev), x, len(cloud))
        a = (fi.xs, fi.ys, fi.zs, fi.valid_f, fi.tile_patch, fi.pad_start, fi.gates,
             fi.consts)
        ref = tiled_fit(*a[:7], fi.consts[0], p)
        for which in libs:
            cs.compare_tables(run(which, a), ref, p, f"{name}, {which} vs plain")
        times = {"A": [], "B": []}
        for _ in range(3):
            for which in "ABBA":
                times[which].append(cs.cuda_ms(lambda: run(which, a), reps=200, warmup=5))
        for which, what in (("A", "as built"), ("B", "every patch staged per walk")):
            v = times[which]
            print(f"{name}: K1 {what}: median {np.median(v):.5f} ms "
                  f"(min {min(v):.5f}, max {max(v):.5f}, {len(v)} timings)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
