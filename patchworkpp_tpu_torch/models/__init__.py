"""Model facade of the PyTorch port."""

from patchworkpp_tpu_torch.models.patchworkpp import PatchworkPP, SegmentationResult

__all__ = ["PatchworkPP", "SegmentationResult"]
