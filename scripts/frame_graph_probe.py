#!/usr/bin/env python3
"""The captured tiled frame on the card: its CUDA graph's size and its time.

Runs the port of the checkout this script sits in (the directory above
``scripts/``), so two trees are compared in one call by running each
tree's copy of the script in turn (parent, change, change, parent). The
default engine's facade, ``PatchworkPP(capacity=131072)``, captures its
frame on ``make_scan(SEED, 0)``; then, over FRAMES chained frames of
``make_scan(SEED, k)``:

- the graph's node count: ``cuGraphGetNodes`` on a second capture of the
  same frame step made with ``CUDAGraph(keep_graph=True)`` ("not measured"
  where this PyTorch lacks it);
- the device operations one frame runs (kernels, copies and sets in a
  ``torch.profiler`` trace of the replays, with the points copy and the
  ``npts`` write of ``CapturedFrame.run`` around each replay);
- the median ms of a frame (``CapturedFrame.run``, CUDA events) over
  ROUNDS rounds of the FRAMES frames.

It prints the card's name and power limit and, last, one JSON line.
``chip_smoke.py`` phase 4e times its frames with ``frame_ms`` and prints
``probe``'s node and operation counts beside them.

Usage: python3 scripts/frame_graph_probe.py
Needs one CUDA card and nvcc (K1 is built at first use).
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CAPACITY = 131072
SEED = 0
FRAMES = 20
ROUNDS = 3


def graph_nodes(cf):
    """(node count, None) of a second capture of ``cf``'s frame step, or
    (None, why not). The launch counters and the state are left as they
    were."""
    import torch

    from patchworkpp_tpu_torch.graphs import COUNTED

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        return None, f"CUDAGraph(keep_graph=True) unsupported: {e}"
    before = [f.launches for f in COUNTED]
    start = cf.state.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        cf._step()
    torch.cuda.current_stream().wait_stream(side)
    cf.state.copy_(start)
    for f, b in zip(COUNTED, before):
        f.launches = b
    try:
        handle = graph.raw_cuda_graph()
        get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
        get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_size_t)]
        get_nodes.restype = ctypes.c_int
        count = ctypes.c_size_t(0)
        rc = get_nodes(handle, None, ctypes.byref(count))
    except (AttributeError, OSError, RuntimeError) as e:
        return None, f"cuGraphGetNodes unavailable: {e}"
    if rc != 0:
        return None, f"cuGraphGetNodes returned {rc}"
    return int(count.value), None


def device_ops_per_frame(cf, xs, npts) -> float:
    """Kernels, copies and sets on the card a frame, over ``len(xs)`` frames."""
    from patchworkpp_tpu_torch.utils.roofline import trace

    events, _ = trace(lambda: [cf.run(x, n) for x, n in zip(xs, npts)])
    return sum(e.on_device and not e.annotation for e in events) / len(xs)


def frame_ms(run, n: int) -> list:
    """CUDA-event ms of each ``run(k)``, k = 0 .. n-1, after ``run(0)``,
    ``run(1)``, ``run(2)`` as warm-up frames; the card idle around each."""
    import torch

    for k in range(min(3, n)):
        run(k)
    out = []
    for k in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run(k)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def probe(cf, xs, npts) -> dict:
    """Node count and device operations a frame of ``cf``."""
    nodes, why = graph_nodes(cf)
    return {"graph_nodes": nodes, "graph_nodes_note": why,
            "device_ops_per_frame": device_ops_per_frame(cf, xs, npts)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("frame_graph_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import patchworkpp_tpu_torch
    from patchworkpp_tpu_torch import PatchworkPP
    from patchworkpp_tpu_torch.cli import workload
    from patchworkpp_tpu_torch.io.synthetic import make_scan

    if Path(patchworkpp_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"patchworkpp_tpu_torch imported from {patchworkpp_tpu_torch.__file__}")
    dev = torch.device("cuda")
    card = workload.card(dev)
    scans = [make_scan(SEED, k) for k in range(FRAMES)]
    m = PatchworkPP(capacity=CAPACITY, device=dev)
    m.estimate_ground(scans[0])  # builds K1 and captures the frame
    frames = list(m._frames.values())
    if len(frames) != 1 or not frames[0].is_captured:
        raise AssertionError("the facade's tiled frame is not captured")
    xs = []
    for s in scans:
        x = torch.zeros((CAPACITY, 4), device=dev)
        x[: len(s)] = torch.from_numpy(s).to(dev)
        xs.append(x)
    cf, npts = frames[0], [len(s) for s in scans]
    out = {"tree": str(ROOT), "card": card, **probe(cf, xs, npts)}
    each = [frame_ms(lambda k: cf.run(xs[k], npts[k]), FRAMES) for _ in range(ROUNDS)]
    out["frame_ms"] = float(np.median(np.concatenate(each)))
    out["frame_ms_rounds"] = [float(np.median(r)) for r in each]
    print(f"card: {card}")
    print(f"{ROOT}: captured tiled frame, {out['graph_nodes']} graph nodes "
          f"({out['graph_nodes_note'] or 'cuGraphGetNodes'}), "
          f"{out['device_ops_per_frame']:g} device operations a frame, "
          f"{out['frame_ms']:.4f} ms a frame (CUDA events, median of "
          f"{ROUNDS} x {FRAMES}; rounds {out['frame_ms_rounds']})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
