"""Profiling and per-stage timing utilities of the PyTorch port."""

from patchworkpp_tpu_torch.utils.profiling import FrameTimer, Recorder, SpanRecord

__all__ = ["FrameTimer", "Recorder", "SpanRecord"]
