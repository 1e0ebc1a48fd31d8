"""Cross-frame adaptive state (PyTorch port of ``patchworkpp_tpu/state.py``).

The reference keeps the adapted ``elevation_thr`` / ``flatness_thr`` /
``sensor_height`` and four per-ring FIFO sample buffers capped at 1000
entries as mutated members (patchworkpp.h:174-175, patchworkpp.cpp:338-375).
Here they are tensors on the engine's device; the frame step returns a new
state and does not mutate its input (a captured frame, ``graphs.py``, then
copies it into its static buffers). Buffers are left-aligned, oldest first,
zero past each ring's count.

The npz checkpoint uses the JAX package's keys, so a state file written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from patchworkpp_tpu_torch.device import resolve_device
from patchworkpp_tpu_torch.params import Params

BUF_CAP = 1064  # max_storage (1000) + the most samples a ring adds per frame
NUM_ADAPT_RINGS = 4

_KEYS = (
    "sensor_height", "elevation_thr", "flatness_thr",
    "elev_buf", "elev_cnt", "flat_buf", "flat_cnt",
)


@dataclasses.dataclass
class AdaptiveState:
    """A-GLE / TGR adaptation state carried across frames."""

    sensor_height: torch.Tensor  # () f32
    elevation_thr: torch.Tensor  # (4,) f32
    flatness_thr: torch.Tensor   # (4,) f32
    elev_buf: torch.Tensor       # (4, BUF_CAP) f32
    elev_cnt: torch.Tensor       # (4,) i32
    flat_buf: torch.Tensor       # (4, BUF_CAP) f32
    flat_cnt: torch.Tensor       # (4,) i32

    def clone(self) -> "AdaptiveState":
        """A copy whose tensors share no memory with this state's."""
        return AdaptiveState(*(getattr(self, k).clone() for k in _KEYS))

    def copy_(self, src: "AdaptiveState") -> "AdaptiveState":
        """Overwrite this state's tensors in place with ``src``'s values
        (any device; shapes must match): how a captured frame's static
        state buffers take a new state (``graphs.py``)."""
        for k in _KEYS:
            getattr(self, k).copy_(getattr(src, k))
        return self

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Checkpoint view: a flat dict of NumPy arrays (the npz keys)."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in _KEYS}

    def save(self, path: str) -> None:
        np.savez(path, **self.to_numpy())

    @classmethod
    def load(cls, path: str, device="cuda") -> "AdaptiveState":
        with np.load(path) as d:
            return from_numpy(d, device)


def from_numpy(d: Mapping[str, Any], device="cuda") -> AdaptiveState:
    """State from a dict of arrays or an open npz file (either package's),
    on ``device`` (CUDA unless asked otherwise; raises without a card).

    Buffer tails past each ring's count are re-zeroed: the frame's FIFO
    append adds new samples at the write offset and relies on zeros there
    (pipeline._write_at), which save() always provides but a hand-edited
    checkpoint might not."""

    def _clean(buf, cnt):
        buf = np.asarray(buf, np.float32)
        cnt = np.asarray(cnt, np.int32)
        mask = np.arange(buf.shape[1])[None, :] < cnt[:, None]
        return np.where(mask, buf, np.float32(0.0))

    dev = resolve_device(device, "the adaptive state")

    def _t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    return AdaptiveState(
        sensor_height=_t(d["sensor_height"], np.float32),
        elevation_thr=_t(d["elevation_thr"], np.float32),
        flatness_thr=_t(d["flatness_thr"], np.float32),
        elev_buf=_t(_clean(d["elev_buf"], d["elev_cnt"]), np.float32),
        elev_cnt=_t(d["elev_cnt"], np.int32),
        flat_buf=_t(_clean(d["flat_buf"], d["flat_cnt"]), np.float32),
        flat_cnt=_t(d["flat_cnt"], np.int32),
    )


def init_state(params: Params, device="cuda") -> AdaptiveState:
    """Fresh state with the configured initial thresholds / sensor height,
    on ``device`` (CUDA unless asked otherwise; raises without a card)."""
    dev = resolve_device(device, "the adaptive state")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return AdaptiveState(
        sensor_height=torch.tensor(params.sensor_height, **f32),
        elevation_thr=torch.tensor(params.elevation_thr, **f32),
        flatness_thr=torch.tensor(params.flatness_thr, **f32),
        elev_buf=torch.zeros((NUM_ADAPT_RINGS, BUF_CAP), **f32),
        elev_cnt=torch.zeros(NUM_ADAPT_RINGS, **i32),
        flat_buf=torch.zeros((NUM_ADAPT_RINGS, BUF_CAP), **f32),
        flat_cnt=torch.zeros(NUM_ADAPT_RINGS, **i32),
    )
