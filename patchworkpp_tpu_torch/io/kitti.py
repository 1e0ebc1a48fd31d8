"""KITTI / SemanticKITTI IO and ground-truth evaluation (the port's own copy of
``patchworkpp_tpu/io/kitti.py``; numpy only).

Scan and label readers, fixed-capacity padding, and precision / recall / F1
of a ground mask against SemanticKITTI semantic labels.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

# SemanticKITTI classes counted as ground, following the Patchwork/Patchwork++
# evaluation protocol (road, parking, sidewalk, other-ground, lane-marking,
# terrain).
GROUND_LABELS = (40, 44, 48, 49, 60, 72)


def read_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: float32 (N, 4) = x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_labels(path: str) -> np.ndarray:
    """SemanticKITTI .label file -> (N,) uint16 semantic class ids.

    The file stores uint32 per point: low 16 bits semantic, high 16 instance.
    """
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.uint16)


def ground_truth_mask(labels: np.ndarray, ground_classes: Sequence[int] = GROUND_LABELS) -> np.ndarray:
    return np.isin(labels, np.asarray(ground_classes, labels.dtype))


def pad_cloud(cloud: np.ndarray, capacity: int) -> Tuple[np.ndarray, np.int32]:
    """Zero-pad (N, 3|4) to (capacity, 4); returns (padded, n)."""
    n = cloud.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    out = np.zeros((capacity, 4), np.float32)
    out[:n, : cloud.shape[1]] = cloud
    return out, np.int32(n)


class EvalResult(NamedTuple):
    precision: float
    recall: float
    f1: float
    accuracy: float
    tp: int
    fp: int
    fn: int
    tn: int


def evaluate_masks(pred_ground: np.ndarray, true_ground: np.ndarray) -> EvalResult:
    """Precision/recall/F1 of a predicted ground mask vs ground truth."""
    pred = pred_ground.astype(bool)
    true = true_ground.astype(bool)
    tp = int(np.sum(pred & true))
    fp = int(np.sum(pred & ~true))
    fn = int(np.sum(~pred & true))
    tn = int(np.sum(~pred & ~true))
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    accuracy = (tp + tn) / max(tp + fp + fn + tn, 1)
    return EvalResult(precision, recall, f1, accuracy, tp, fp, fn, tn)


class ScanDataset:
    """A directory of KITTI .bin scans (optionally with SemanticKITTI labels).

    Layout conventions supported:
    - flat: ``dir/*.bin`` (like the reference's bundled ``data/``);
    - SemanticKITTI: ``root/sequences/XX/velodyne/*.bin`` +
      ``root/sequences/XX/labels/*.label``.
    """

    def __init__(self, scan_dir: str, label_dir: Optional[str] = None) -> None:
        self.scan_dir = scan_dir
        self.label_dir = label_dir
        self.names: List[str] = sorted(
            os.path.splitext(f)[0] for f in os.listdir(scan_dir) if f.endswith(".bin")
        )
        if not self.names:
            raise FileNotFoundError(f"no .bin scans under {scan_dir}")

    @classmethod
    def semantickitti(cls, root: str, sequence: str) -> "ScanDataset":
        base = os.path.join(root, "sequences", sequence)
        label_dir = os.path.join(base, "labels")
        return cls(
            os.path.join(base, "velodyne"),
            label_dir if os.path.isdir(label_dir) else None,
        )

    def __len__(self) -> int:
        return len(self.names)

    def scan(self, i: int) -> np.ndarray:
        return read_bin(os.path.join(self.scan_dir, self.names[i] + ".bin"))

    def labels(self, i: int) -> Optional[np.ndarray]:
        if self.label_dir is None:
            return None
        return read_labels(os.path.join(self.label_dir, self.names[i] + ".label"))

    def __iter__(self):
        for i in range(len(self)):
            yield self.scan(i), self.labels(i)
