"""Data layer: KITTI/SemanticKITTI readers, padding, evaluation, and the
synthetic scans that stand in where no KITTI scan is at hand."""

from patchworkpp_tpu_torch.io.kitti import (
    GROUND_LABELS,
    EvalResult,
    ScanDataset,
    evaluate_masks,
    ground_truth_mask,
    pad_cloud,
    read_bin,
    read_labels,
)

__all__ = [
    "read_bin",
    "read_labels",
    "pad_cloud",
    "ScanDataset",
    "GROUND_LABELS",
    "EvalResult",
    "ground_truth_mask",
    "evaluate_masks",
]
