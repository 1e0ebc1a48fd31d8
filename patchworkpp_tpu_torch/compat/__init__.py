"""Compatibility facades for downstream users of the reference APIs."""

from patchworkpp_tpu_torch.compat import pypatchworkpp

__all__ = ["pypatchworkpp"]
