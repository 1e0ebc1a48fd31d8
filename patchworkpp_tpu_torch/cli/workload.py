"""The scans the port's CLIs run, and the device they report.

The workload is a cycle of six scans: the KITTI scans 000000-000005.bin of
the directory named by ``PPK_DATA_DIR`` when that variable is set, else the
synthetic 64-beam scans ``io/synthetic.make_scan(seed, 0..5)`` (~120k points
each, one scene with the sensor moving 5 cm a frame).
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np
import torch

from patchworkpp_tpu_torch.io.kitti import read_bin
from patchworkpp_tpu_torch.io.synthetic import make_scan

DATA_ENV = "PPK_DATA_DIR"
CYCLE = 6


def scan_paths(data_dir: str) -> List[str]:
    """The cycle's six files, ``data_dir``/000000.bin .. 000005.bin; raises
    FileNotFoundError when one is missing."""
    paths = [os.path.join(data_dir, f"{i:06d}.bin") for i in range(CYCLE)]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"{data_dir} lacks {missing}")
    return paths


def scan_cycle(seed: int = 0, sub: int = 1) -> Tuple[str, List[np.ndarray]]:
    """(workload name, six scans): ("kitti6", the KITTI scans of
    ``$PPK_DATA_DIR``) when the variable is set, else ("synth6",
    ``make_scan(seed, 0..5)``). ``sub`` > 1 keeps every ``sub``-th point (a
    sparser feed, or a small run on the CPU)."""
    data_dir = os.environ.get(DATA_ENV)
    if data_dir:
        name, scans = "kitti6", [read_bin(p) for p in scan_paths(data_dir)]
    else:
        name, scans = "synth6", [make_scan(seed, i) for i in range(CYCLE)]
    if sub > 1:
        scans = [s[::sub].copy() for s in scans]
    return name, scans


def resolve_device(name: str) -> torch.device:
    """The device a CLI was asked for; CUDA without a card is an error (no
    quiet fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return dev


def card(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (a number without them
    is not kept, so a failing nvidia-smi raises); None on the CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
