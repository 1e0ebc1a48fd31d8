"""Profiling and per-stage timing utilities of the PyTorch port."""

from patchworkpp_tpu_torch.utils.profiling import FrameTimer, profile_trace

__all__ = ["FrameTimer", "profile_trace"]
