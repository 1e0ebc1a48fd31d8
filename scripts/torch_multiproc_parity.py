#!/usr/bin/env python3
"""Multi-process exact-parity gate of the PyTorch port's parallel layer
(the analog of ``scripts/multihost_parity.py --quick``).

The parent spawns N processes joined by a gloo process group (a ``file://``
store in a temporary directory, no TCP port); every rank runs:

  point-sharded   frames 0 and 1, fresh, their rows split over the N ranks
                  (``parallel.make_point_sharded_frame_fn``)
  chain           frames 0..2 through the point-sharded sequence, the
                  adapted state carried (and the same three frames through
                  the point-sharded frame in a loop)
  shard x chunk   frame 0 over N ranks x 2 chunks
                  (``parallel.make_sharded_chunked_frame_fn``)
  frame-parallel  N fresh streams, one per rank, stream b on frame b % 3
                  (``parallel.make_batch_frame_fn``)

and writes its results to ``rank<r>.npz``. Meanwhile the parent runs the
same engines in one process: the chunked frame at K = N (the point-sharded
program of N shards), its sequence, the chunked frame at K = 2N (the flat
program the composition equals) and the plain frame per stream. Every
field of every rank's FrameResult and state must equal the single-process
run bit for bit; the chain must also equal the loop. Prints one PASS or
FAIL line per check, then ``{"multiproc_parity": "PASS"}`` (exit 0) or
``"FAIL"`` (exit 1).

The frames are ``io/synthetic.make_scan(0, 0..2)[::16]`` (~7.5k points) at
capacity 8192. Every rank and the parent run on the card unless given
``--device cpu``; without CUDA the script raises.

Usage: python3 scripts/torch_multiproc_parity.py [--nprocs 2]
[--device cuda|cpu] [--out DIR] [--timeout 300]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FRAMES = 3
CAPACITY, SUB = 8192, 16
FIELDS = ("ground_mask", "num_ground", "patch_mean", "patch_normal", "patch_svals",
          "patch_processed")


def _clouds():
    """(3, CAPACITY, 4) padded stack of make_scan(0, 0..2)[::SUB] and the
    point counts."""
    from patchworkpp_tpu_torch.io.synthetic import make_scan

    stack = np.zeros((FRAMES, CAPACITY, 4), np.float32)
    npts = []
    for f in range(FRAMES):
        c = make_scan(0, f)[::SUB]
        stack[f, : len(c)] = c
        npts.append(len(c))
    return stack, npts


def _flat(prefix: str, state, res=None) -> dict:
    """One run's arrays under ``prefix``: every state field and every
    FrameResult field (of ``res``, where given)."""
    out = {f"{prefix}state_{k}": v for k, v in state.to_numpy().items()}
    if res is not None:
        out.update({f"{prefix}{k}": getattr(res, k).cpu().numpy() for k in FIELDS})
    return out


def _frame(res, f: int):
    """Frame ``f`` of a sequence's stacked FrameResult."""
    return res._replace(**{k: getattr(res, k)[f] for k in FIELDS})


def run_engines(p, dev, stack, npts, nprocs: int, sharded: bool) -> dict:
    """Every configuration, point-sharded over the process group
    (``sharded``) or its single-process counterpart. Returns the arrays."""
    import torch

    from patchworkpp_tpu_torch import init_state
    from patchworkpp_tpu_torch.parallel import (
        batch_init_state,
        make_batch_frame_fn,
        make_chunked_frame_fn,
        make_chunked_sequence_fn,
        make_point_sharded_frame_fn,
        make_point_sharded_sequence_fn,
        make_sharded_chunked_frame_fn,
    )
    from patchworkpp_tpu_torch.parallel.sharded import stream_state
    from patchworkpp_tpu_torch.pipeline import make_frame_fn

    x = torch.from_numpy(stack).to(dev)
    out = {}
    if sharded:
        frame = make_point_sharded_frame_fn(p, device=dev)
        seq = make_point_sharded_sequence_fn(p, device=dev)
        comp = make_sharded_chunked_frame_fn(p, 2, device=dev)
    else:
        frame = make_chunked_frame_fn(p, nprocs, device=dev)
        seq = make_chunked_sequence_fn(p, nprocs, device=dev)
        comp = make_chunked_frame_fn(p, 2 * nprocs, device=dev)
    for f in range(2):
        out.update(_flat(f"ps{f}_", *frame(init_state(p, dev), x[f], npts[f])))
    st, res = seq(init_state(p, dev), x, npts)
    out.update(_flat("chain_", st))
    for f in range(FRAMES):
        out.update({f"chain{f}_{k}": v for k, v in _flat("", st, _frame(res, f)).items()
                    if not k.startswith("state_")})
    if sharded:  # the same chain through the frame, in a loop
        st = init_state(p, dev)
        for f in range(FRAMES):
            st, res = frame(st, x[f], npts[f])
            out.update({f"loop{f}_{k}": v for k, v in _flat("", st, res).items()
                        if not k.startswith("state_")})
        out.update(_flat("loop_", st))
    out.update(_flat("sxc_", *comp(init_state(p, dev), x[0], npts[0])))

    streams = [b % FRAMES for b in range(nprocs)]
    if sharded:
        states, res = make_batch_frame_fn(p, device=dev)(
            batch_init_state(p, nprocs, dev), x[streams], [npts[f] for f in streams])
        for b in range(nprocs):
            out.update(_flat(f"fp{b}_", stream_state(states, b), _frame(res, b)))
    else:
        plain = make_frame_fn(p, device=dev)
        for b, f in enumerate(streams):
            out.update(_flat(f"fp{b}_", *plain(init_state(p, dev), x[f], npts[f])))
    return out


def _rank(rank: int, nprocs: int, cfg: dict) -> None:
    import torch

    from patchworkpp_tpu_torch import Params

    stack, npts = _clouds()
    out = run_engines(Params(), torch.device(cfg["device"]), stack, npts, nprocs, True)
    np.savez(os.path.join(cfg["out"], f"rank{rank}.npz"), **out)


def compare(ranks, ref: dict, nprocs: int) -> list:
    """(label, ok, detail) per check: every rank's arrays against the
    single-process run, and the chain against the loop."""
    checks = []
    groups = {
        f"point-sharded x{nprocs}, fresh frames 0-1 == chunked K={nprocs}": ("ps0_", "ps1_"),
        f"point-sharded x{nprocs} chain of {FRAMES} == chunked K={nprocs} sequence":
            ("chain",),
        f"shard x chunk {nprocs}x2 == chunked K={2 * nprocs}": ("sxc_",),
        f"frame-parallel x{nprocs} == plain frame per stream":
            tuple(f"fp{b}_" for b in range(nprocs)),
    }
    for label, prefixes in groups.items():
        bad = [f"rank {r}: {k}" for r, got in enumerate(ranks) for k in ref
               if k.startswith(prefixes) and not np.array_equal(got[k], ref[k])]
        checks.append((label, not bad, "; ".join(bad[:4])))
    bad = [f"rank {r}: {k}" for r, got in enumerate(ranks) for k in got
           if k.startswith("loop") and not np.array_equal(got[k], got["chain" + k[4:]])]
    checks.append((f"point-sharded x{nprocs} sequence == frame loop", not bad,
                   "; ".join(bad[:4])))
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="directory for the ranks' npz files")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    import torch

    from patchworkpp_tpu_torch import Params
    from patchworkpp_tpu_torch.device import resolve_device
    from patchworkpp_tpu_torch.parallel.selfcheck import spawn

    dev = resolve_device(args.device)
    if CAPACITY % (2 * args.nprocs):
        raise SystemExit(f"capacity {CAPACITY} not divisible by 2 x --nprocs")
    with tempfile.TemporaryDirectory(prefix="ppk_parity_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        cfg = {"device": str(dev), "out": out_dir}
        stack, npts = _clouds()
        with ThreadPoolExecutor(1) as pool:  # the ranks run while the parent does
            ranks_done = pool.submit(spawn, _rank, args.nprocs, (cfg,), args.timeout)
            ref = run_engines(Params(), dev, stack, npts, args.nprocs, False)
            ranks_done.result()
        np.savez(os.path.join(out_dir, "reference.npz"), **ref)
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(args.nprocs)]
    checks = compare(ranks, ref, args.nprocs)
    for label, ok, detail in checks:
        print(f"{'PASS' if ok else 'FAIL'} {label}" + ("" if ok else f": {detail}"))
    ok = all(c[1] for c in checks)
    print(f"points {npts}, device {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    print(json.dumps({"multiproc_parity": "PASS" if ok else "FAIL"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
