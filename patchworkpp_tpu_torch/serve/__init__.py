"""Serving layer: streaming ground segmentation for live point-cloud feeds."""

from patchworkpp_tpu_torch.serve.multi_stream import MultiStreamSegmenter
from patchworkpp_tpu_torch.serve.server import (
    CloudMsg,
    GroundSegmentationServer,
    ResultMsg,
    ServerConfig,
)

__all__ = [
    "GroundSegmentationServer",
    "CloudMsg",
    "ResultMsg",
    "ServerConfig",
    "MultiStreamSegmenter",
]
