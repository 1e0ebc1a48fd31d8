#!/usr/bin/env python3
"""Exact parity gate of the PyTorch / CUDA port: its engines vs golden index sets.

Runs the 12 golden configurations (6 scans fresh-per-scan + 6 sequential,
full resolution) through the port's facade (``patchworkpp_tpu_torch.
PatchworkPP``) on ``--device`` (the card by default: the default engine
launches fit kernel K1, ``onehot`` kernel K2, ``False`` the unfused engine)
and asserts per-point ground-index equality with the golden npz (keys
``fresh_<name>`` and ``seq_<name>``; ``golden/reference_ground_indices.npz``
holds the compiled C++ reference's).

The image of ``scripts/tpu_parity.py`` for the port. It imports numpy and
the port only, so it runs where no JAX is installed.

Usage:
  python3 scripts/gpu_parity.py                  # $PPK_DATA_DIR, on cuda
  python3 scripts/gpu_parity.py --scan-dir DIR --golden NPZ --device cpu
  python3 scripts/gpu_parity.py --modes None onehot

Output: one PASS/FAIL line per mode and configuration with its mismatch
count, then ``PARITY: OK`` or ``PARITY: N FAILURES``; the exit code is
nonzero on any FAIL, and nonzero with a message when the scans are missing
(it never passes on nothing).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_NAMES = [f"{i:06d}" for i in range(6)]
MODES = {"None": None, "True": True, "False": False}


def _mode(text: str):
    """A ``fused=`` value from its command-line spelling."""
    return MODES.get(text, text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", default=os.path.join(REPO, "golden",
                                                     "reference_ground_indices.npz"))
    ap.add_argument("--scan-dir", default=os.environ.get("PPK_DATA_DIR"),
                    help="directory of 000000.bin .. 000005.bin (default $PPK_DATA_DIR)")
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--modes", nargs="+", default=["None", "onehot", "False"],
                    help="fused= values to gate: None, onehot, False, tiled, grid, ...")
    args = ap.parse_args(argv)

    if not args.scan_dir:
        print("gpu_parity: no scans: pass --scan-dir or set PPK_DATA_DIR", file=sys.stderr)
        return 2
    paths = [os.path.join(args.scan_dir, f"{n}.bin") for n in SCAN_NAMES]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"gpu_parity: scans missing: {missing}", file=sys.stderr)
        return 2

    sys.path.insert(0, REPO)
    from patchworkpp_tpu_torch import PatchworkPP
    from patchworkpp_tpu_torch.cli.workload import card, resolve_device
    from patchworkpp_tpu_torch.io.kitti import read_bin

    dev = resolve_device(args.device)
    scans = [read_bin(p) for p in paths]
    print(f"device: {card(dev) or dev}; scans: {args.scan_dir}; golden: {args.golden}",
          flush=True)
    with np.load(args.golden) as z:
        golden = {k: z[k] for k in z.files}

    failures = 0
    for text in args.modes:
        label = f"fused={text}"
        model = PatchworkPP(capacity=args.capacity, device=str(dev), fused=_mode(text))
        t0 = time.perf_counter()
        for variant in ("fresh", "seq"):
            model.reset()
            for name, cloud in zip(SCAN_NAMES, scans):
                if variant == "fresh":
                    model.reset()
                got = model.estimate_ground(cloud).ground_indices
                key = f"{variant}_{name}"
                if key not in golden:
                    print(f"[{label}] {key}: FAIL (no such key in the golden npz)", flush=True)
                    failures += 1
                    continue
                mism = len(np.setxor1d(got, golden[key]))
                ok = mism == 0 and len(got) == len(golden[key])
                print(f"[{label}] {key}: " + ("PASS" if ok else "FAIL")
                      + f" ({mism} mismatched indices)", flush=True)
                failures += 0 if ok else 1
        print(f"[{label}] 12 configurations in {time.perf_counter() - t0:.1f} s "
              "(the first includes the kernel build)", flush=True)

    print("PARITY: " + ("OK" if failures == 0 else f"{failures} FAILURES"))
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
