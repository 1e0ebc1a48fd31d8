"""SemanticKITTI ground-segmentation evaluation (port of
``patchworkpp_tpu/cli/eval_semantickitti.py``).

Streams a sequence through the port's engine with adapted state and reports
precision/recall/F1/accuracy against the semantic labels (ground classes:
road, parking, sidewalk, other-ground, lane-marking, terrain), plus
per-frame latency and the adapted sensor height; or, with ``--golden``,
against a golden npz of ground indices (exact parity shows as
precision = recall = f1 = 1.0). Runs on CUDA unless given ``--device cpu``.

Usage:
  python3 -m patchworkpp_tpu_torch.cli.eval_semantickitti --root /data/semantickitti --seq 00
  python3 -m patchworkpp_tpu_torch.cli.eval_semantickitti --scan-dir DIR   # no labels: timing only
  python3 -m patchworkpp_tpu_torch.cli.eval_semantickitti --scan-dir DIR \\
      --golden golden/reference_ground_indices.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from patchworkpp_tpu_torch.cli.workload import resolve_device
from patchworkpp_tpu_torch.io.kitti import ScanDataset, evaluate_masks, ground_truth_mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="SemanticKITTI root (contains sequences/)")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--scan-dir", help="flat dir of .bin scans (no labels)")
    ap.add_argument("--limit", type=int, default=0, help="max frames (0 = all)")
    ap.add_argument("--capacity", type=int, default=131072)
    ap.add_argument("--json", action="store_true", help="one JSON line output")
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per estimate_ground_sequence call (equal to "
                         "the per-frame loop; one readback per call)")
    ap.add_argument("--golden", help="npz of ground indices to score against instead "
                                     "of SemanticKITTI labels; keys <variant>_<scanname>")
    ap.add_argument("--golden-variant", default="seq", choices=["seq", "fresh"],
                    help="golden key prefix: 'seq' matches streaming with adapted state")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.root:
        ds = ScanDataset.semantickitti(args.root, args.seq)
    elif args.scan_dir:
        ds = ScanDataset(args.scan_dir)
    else:
        ap.error("need --root or --scan-dir")

    from patchworkpp_tpu_torch import Params, PatchworkPP

    dev = resolve_device(args.device)
    model = PatchworkPP(Params(), capacity=args.capacity, device=str(dev))
    golden = dict(np.load(args.golden)) if args.golden else None

    def truth(j: int, n: int):
        if golden is None:
            labels = ds.labels(j)
            return ground_truth_mask(labels) if labels is not None else None
        key = f"{args.golden_variant}_{ds.names[j]}"
        if key not in golden:
            return None
        m = np.zeros(n, bool)
        m[golden[key]] = True
        return m

    tp = fp = fn_ = tn = 0
    times = []
    n_frames = len(ds) if args.limit == 0 else min(args.limit, len(ds))
    i = 0
    while i < n_frames:
        if args.batch > 1 and i + args.batch <= n_frames:
            idxs = range(i, i + args.batch)
            results = model.estimate_ground_sequence([ds.scan(j) for j in idxs])
            times.append(results[0].time_taken_s / len(results))
        else:
            idxs = range(i, i + 1)
            results = [model.estimate_ground(ds.scan(i))]
            times.append(results[0].time_taken_s)
        for j, res in zip(idxs, results):
            gt = truth(j, len(res.ground_mask))
            if gt is not None:
                r = evaluate_masks(res.ground_mask, gt)
                tp, fp, fn_, tn = tp + r.tp, fp + r.fp, fn_ + r.fn, tn + r.tn
        i += len(results)

    # The first call builds the kernel: left out of the latency. With
    # --batch > 1 each entry is a call's wall time per frame (throughput).
    lat = np.asarray(times[1:] or times)
    out = {
        "frames": n_frames,
        "batch": args.batch,
        "device": str(dev),
        "mean_latency_ms": float(lat.mean() * 1e3),
        "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
        "scans_per_s": float(1.0 / lat.mean()),
        "sensor_height": model.sensor_height,
    }
    if tp + fp + fn_ + tn > 0:
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn_, 1)
        out.update(
            precision=precision,
            recall=recall,
            f1=2 * precision * recall / max(precision + recall, 1e-12),
            accuracy=(tp + tn) / (tp + fp + fn_ + tn),
        )
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
