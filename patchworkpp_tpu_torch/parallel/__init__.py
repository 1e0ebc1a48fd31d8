"""Parallel and distributed execution of the frame (port of
``patchworkpp_tpu/parallel/``), over ``torch.distributed`` process groups
and, within one device, chunk threads:

- frame data parallelism: independent streams split over the ranks, each
  with its own adaptive state, the plain frame (K1 on the card) on each;
- point sharding within a frame (the dense-scan path): per-patch statistics
  combined by fixed-order gathers between the fit program's passes;
- single-device chunking: the point-sharded per-shard program over K chunk
  threads, the sharded program's emulation on one device and the building
  block of the shard x chunk composition; not a speed lever.

Every entry point runs on CUDA unless given ``device="cpu"``.
"""

from patchworkpp_tpu_torch.parallel.chunked import (
    make_chunked_frame_fn,
    make_chunked_sequence_fn,
    make_sharded_chunked_frame_fn,
)
from patchworkpp_tpu_torch.parallel.sharded import (
    batch_init_state,
    make_batch_frame_fn,
    make_point_sharded_frame_fn,
    make_point_sharded_sequence_fn,
)

__all__ = [
    "make_batch_frame_fn",
    "make_point_sharded_frame_fn",
    "make_point_sharded_sequence_fn",
    "make_chunked_frame_fn",
    "make_chunked_sequence_fn",
    "make_sharded_chunked_frame_fn",
    "batch_init_state",
]
