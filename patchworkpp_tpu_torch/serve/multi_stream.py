"""Multi-stream multiplexing on one device (port of
``patchworkpp_tpu/serve/multi_stream.py``).

N streams share one engine (one set of built frame functions and kernels)
and each keeps its own :class:`AdaptiveState` on the device; their frames
are interleaved through the one frame step. The reference ROS node handles
exactly one topic per process (ros/src/GroundSegmentationServer.cpp);
multi-stream is a capability add.
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional

import numpy as np

from patchworkpp_tpu_torch.models import PatchworkPP, SegmentationResult
from patchworkpp_tpu_torch.params import Params
from patchworkpp_tpu_torch.state import AdaptiveState, from_numpy, init_state


class MultiStreamSegmenter:
    """N independent adaptive streams through one shared engine.

    Each stream id owns its own :class:`AdaptiveState` (thresholds, FIFO
    buffers, self-calibrated sensor height), exactly as N reference engine
    instances would. ``device`` is "cuda" unless the caller asks for "cpu";
    ``chunks`` > 1 runs each frame chunked (``PatchworkPP(chunks=...)``).
    """

    def __init__(
        self,
        params: Optional[Params] = None,
        capacity: int = 131072,
        chunks: int = 1,
        device: Optional[str] = None,
    ) -> None:
        self._model = PatchworkPP(params, capacity=capacity, device=device, chunks=chunks)
        self._states: Dict[Hashable, AdaptiveState] = {}

    @property
    def streams(self):
        return list(self._states)

    def segment(self, stream_id: Hashable, cloud: np.ndarray) -> SegmentationResult:
        """Segment one scan of ``stream_id``, advancing only its state."""
        m = self._model
        st = self._states.get(stream_id)
        m.state = st if st is not None else init_state(m.params, m.device)
        try:
            return m.estimate_ground(cloud)
        finally:
            self._states[stream_id] = m.state

    def sensor_height(self, stream_id: Hashable) -> float:
        return float(self._states[stream_id].sensor_height)

    def reset(self, stream_id: Hashable) -> None:
        self._states.pop(stream_id, None)

    # ------------------------------------------------------------ persistence

    def save_states(self, path: str) -> None:
        """Checkpoint every stream's adaptive state into one npz (keys are
        ``<field>:<stream_id>``, the JAX package's); a restarted multiplexer
        of either package resumes all chains exactly. Stream ids must be
        str()-able round-trippably."""
        out = {}
        for sid, st in self._states.items():
            for k, v in st.to_numpy().items():
                out[f"{k}:{sid}"] = v
        np.savez(path, **out)

    def load_states(self, path: str) -> None:
        """Restore a :meth:`save_states` checkpoint (string stream ids)."""
        with np.load(path) as data:
            per_stream: Dict[str, Dict[str, np.ndarray]] = {}
            for key, v in data.items():
                k, sid = key.split(":", 1)
                per_stream.setdefault(sid, {})[k] = v
        for sid, d in per_stream.items():
            self._states[sid] = from_numpy(d, self._model.device)
