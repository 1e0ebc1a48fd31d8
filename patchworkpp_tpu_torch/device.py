"""Where the port's entry points run: CUDA unless the caller asks for
another device, and never a quiet fallback to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda", what: str = "the port") -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
