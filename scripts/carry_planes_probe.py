#!/usr/bin/env python3
"""What the plane carry (``pipeline.carry_planes``) adds to the captured
frame on the card.

Under ``ros_launch_params`` (``num_min_pts`` 0) the frame builds the carry;
with ``num_min_pts`` 1 it does not, and processes the same patches but the
empty ones, whose fits hold no point either way. So the two facades'
captured frames differ by the carry's operations. Over FRAMES chained
frames of ``make_scan(SEED, k)`` this prints, for each, the graph's node
count and device operations a frame (``frame_graph_probe.py``'s helpers),
the summed device time of its kernels, copies and sets a frame (a
``torch.profiler`` trace of the replays; the gaps between them left out)
and the median CUDA-event ms a frame, the two frames timed in turns (A B B
A, ROUNDS times), then one JSON line.

Usage: python3 scripts/carry_planes_probe.py
Needs one CUDA card and nvcc (K1 is built at first use).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from frame_graph_probe import CAPACITY, FRAMES, ROUNDS, SEED, frame_ms, probe  # noqa: E402


def device_us_per_frame(cf, xs, npts) -> float:
    """Summed duration of the card's kernels, copies and sets a frame."""
    from patchworkpp_tpu_torch.utils.roofline import trace

    events, _ = trace(lambda: [cf.run(x, n) for x, n in zip(xs, npts)])
    return sum(e.dur_us for e in events if e.on_device and not e.annotation) / len(xs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("carry_planes_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from patchworkpp_tpu_torch import PatchworkPP
    from patchworkpp_tpu_torch.cli import workload
    from patchworkpp_tpu_torch.io.synthetic import make_scan
    from patchworkpp_tpu_torch.models.presets import ros_launch_params

    dev = torch.device("cuda")
    scans = [make_scan(SEED, k) for k in range(FRAMES)]
    xs = []
    for s in scans:
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(s)] = torch.from_numpy(s).to(dev)
        xs.append(x)
    npts = [len(s) for s in scans]
    frames = {}
    for name, min_pts in (("carry", 0), ("no_carry", 1)):
        m = PatchworkPP(ros_launch_params(num_min_pts=min_pts), capacity=CAPACITY, device=dev)
        m.estimate_ground(scans[0])  # builds K1 and captures the frame
        (cf,) = m._frames.values()
        assert cf.is_captured and (cf.inherited_planes is not None) == (min_pts == 0)
        frames[name] = cf
    out = {"card": workload.card(dev)}
    for name, cf in frames.items():
        out[name] = probe(cf, xs, npts)
        out[name]["device_us"] = device_us_per_frame(cf, xs, npts)
    times = {name: [] for name in frames}
    for _ in range(ROUNDS):
        for name in ("carry", "no_carry", "no_carry", "carry"):
            cf = frames[name]
            times[name] += frame_ms(lambda k: cf.run(xs[k], npts[k]), FRAMES)
    for name in frames:
        out[name]["frame_ms"] = float(np.median(times[name]))
    added = {k: out["carry"][k] - out["no_carry"][k] if out["carry"][k] is not None else None
             for k in ("graph_nodes", "device_ops_per_frame", "device_us", "frame_ms")}
    out["carry_adds"] = added
    print(f"card: {out['card']}")
    print(f"the carry adds {added['graph_nodes']} graph nodes, "
          f"{added['device_ops_per_frame']:g} device operations, "
          f"{added['device_us']:.1f} us of device time and "
          f"{added['frame_ms'] * 1e3:.1f} us a frame (median of {ROUNDS} x 2 x {FRAMES} "
          f"frames each, CUDA events)")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
