"""Long-horizon adaptivity soak (port of ``patchworkpp_tpu/cli/soak.py``).

Runs thousands of state-chained frames through the sequence step (the
bench's dispatch shape: ``make_sequence_fn`` over the six-scan cycle tiled
``--repeat`` times; on the card one captured frame replayed once a frame,
``graphs.py``, as the JAX soak jits the sequence) and checks what an unbounded deployment needs; the
reference runs unbounded sequences with its buffers FIFO-trimmed at 1000
(cpp/patchworkpp/src/patchworkpp.cpp:338-375):

  - finiteness at every probe: sensor_height, and at the end the
    thresholds and the buffer contents;
  - bounds: sensor_height within (1.0, 2.5) m, elevation_thr < 5 m,
    flatness_thr < 1;
  - FIFO invariants: buffer counts fill and then pin at max storage (1000),
    never exceed it, never shrink;
  - throughput stability: the last quarter's group rate within 25% of the
    first quarter's (a monotone slowdown is a leak in the dispatch chain).

Each group of dispatches ends in one scalar read (the sync) and reads the
small count vectors; the buffers are read once at the end. Prints one JSON
line and exits 1 when a check fails.

Usage: python3 -m patchworkpp_tpu_torch.cli.soak [--frames 3000]
[--groups 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from patchworkpp_tpu_torch.cli.workload import card, resolve_device, scan_cycle


def rate_failures(rates) -> list:
    """The stability check: the median rate of the last quarter of groups
    must stay above 75% of the first quarter's."""
    q = max(1, len(rates) // 4)
    first = float(np.median(rates[:q]))
    last = float(np.median(rates[-q:]))
    if last < 0.75 * first:
        return [f"throughput decayed {first:.1f} -> {last:.1f} scans/s"]
    return []


def run(args) -> dict:
    from patchworkpp_tpu_torch import Params, init_state
    from patchworkpp_tpu_torch.cli.bench import build_stack
    from patchworkpp_tpu_torch.pipeline import make_sequence_fn

    dev = resolve_device(args.device)
    workload, scans = scan_cycle(args.seed, args.sub)
    stack6, npts6 = build_stack(scans, 1, args.capacity)
    rep = max(1, args.repeat)
    stack = torch.from_numpy(np.tile(stack6, (rep, 1, 1))).to(dev)
    npts = [int(n) for n in np.tile(npts6, rep)]
    fpd = len(npts)

    params = Params()
    seq = make_sequence_fn(params, device=dev)
    epochs = max(1, args.frames // fpd)
    groups = min(args.groups, epochs)
    base, rem = divmod(epochs, groups)
    sizes = [base + (1 if g < rem else 0) for g in range(groups)]

    st = init_state(params, dev)
    for _ in range(2):  # warm-up: builds the kernel, captures the frame
        st, _ = seq(st, stack, npts)
    st.sensor_height.item()

    failures = []
    rates = []
    heights = []
    prev_cnt = None
    frames = 0
    for g in range(groups):
        t0 = time.perf_counter()
        for _ in range(sizes[g]):
            st, _ = seq(st, stack, npts)
        sh = st.sensor_height.item()  # the group's sync point
        rates.append(sizes[g] * fpd / (time.perf_counter() - t0))
        frames += sizes[g] * fpd
        heights.append(sh)
        if not np.isfinite(sh) or not (1.0 < sh < 2.5):
            failures.append(f"group {g}: sensor_height {sh}")
        ec = st.elev_cnt.cpu().numpy()
        fc = st.flat_cnt.cpu().numpy()
        if ((ec < 0).any() or (ec > params.max_elevation_storage).any()
                or (fc < 0).any() or (fc > params.max_flatness_storage).any()):
            failures.append(f"group {g}: buffer counts out of range {ec} {fc}")
        if prev_cnt is not None and (ec < prev_cnt).any():
            failures.append(f"group {g}: buffer count shrank {prev_cnt}->{ec}")
        prev_cnt = ec

    state = st.to_numpy()  # the full audit, once, outside timing
    for name in ("elevation_thr", "flatness_thr", "elev_buf", "flat_buf"):
        if not np.isfinite(state[name]).all():
            failures.append(f"non-finite {name}")
    if (np.abs(state["elevation_thr"]) > 5.0).any():
        failures.append(f"elevation_thr unbounded: {state['elevation_thr']}")
    if (np.abs(state["flatness_thr"]) > 1.0).any():
        failures.append(f"flatness_thr unbounded: {state['flatness_thr']}")
    if (int(state["elev_cnt"][0]) < min(params.max_elevation_storage, frames * 10)
            and frames * 16 > 2 * params.max_elevation_storage):
        failures.append("ring-0 buffer never saturated — trim path unexercised")
    failures += rate_failures(rates)
    q = max(1, groups // 4)
    return {
        "metric": f"{workload}_soak_frames",
        "frames": frames,
        "scans_per_s_groups": rates,
        "first_quarter": float(np.median(rates[:q])),
        "last_quarter": float(np.median(rates[-q:])),
        "sensor_height_first": heights[0],
        "sensor_height_last": heights[-1],
        "elev_cnt": state["elev_cnt"].tolist(),
        "flat_cnt": state["flat_cnt"].tolist(),
        "card": card(dev),
        "ok": not failures,
        "failures": failures,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3000)
    ap.add_argument("--groups", type=int, default=8,
                    help="probe points (scalar read + finiteness check)")
    ap.add_argument("--repeat", type=int, default=4,
                    help="frames per dispatch = 6 * repeat")
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--sub", type=int, default=1, metavar="K",
                    help="keep every K-th point of each scan (a small run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    record = run(ap.parse_args(argv))
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
