"""Model facade of the PyTorch port."""

from patchworkpp_tpu_torch.models.patchworkpp import PatchworkPP, SegmentationResult
from patchworkpp_tpu_torch.models.presets import patchwork_params, ros_launch_params

__all__ = [
    "PatchworkPP",
    "SegmentationResult",
    "patchwork_params",
    "ros_launch_params",
]
