"""The per-patch sum kernel KR: the unfused engine's ``ops.patch_reduce``
as one CUDA launch.

No TPU kernel is replaced: the JAX package's per-patch sum is XLA
(``patchworkpp_tpu/ops/onehot.py:patch_reduce``). The source is
``csrc/patch_reduce.cu``, built by ``ops/nvcc.py`` at the first call. Its
plain version is ``ops/onehot.py:patch_reduce_reference``, which it equals
bit for bit: each patch's rows in 128-row chunks, each chunk summed in
``ops.tree_sum``'s order, the chunk sums added in order from +0.0. Where a
patch's rows are is read on the card (``start``), so the call reads nothing
back to the host and a captured frame can hold it (the plain version reads
the longest patch's chunk count to the host).

``ops/onehot.py:patch_reduce`` runs this kernel on a CUDA tensor and the
plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from patchworkpp_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "patch_reduce.cu"
# ppk_patch_reduce's parameters, in order: feats start num_patches cols out stream
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p)


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/patch_reduce.cu (once per source content) and load it."""
    lib = nvcc.build(SOURCE, "ppk_patch_reduce", ARGTYPES)
    lib.ppk_patch_reduce_max_cols.argtypes = []
    lib.ppk_patch_reduce_max_cols.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


def patch_reduce_kernel(feats: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """(S, C) per-patch sums of ``feats`` (P, C) f32 over the row runs
    ``[start[s], start[s+1])`` of ``start`` (S+1,) int32 (nondecreasing,
    within [0, P]), on the card: one launch on the current stream, counted
    in ``patch_reduce_kernel.launches``.

    Raises on a tensor that is not on a CUDA device (the CPU runs
    ``ops/onehot.py:patch_reduce_reference``), on a dtype, shape or device it
    does not take, and on a failed build or launch."""
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"the per-patch sum kernel KR runs on CUDA tensors, not {dev}; on "
                         "the CPU ops/onehot.py:patch_reduce runs patch_reduce_reference")
    if feats.dim() != 2:
        raise ValueError(f"feats must be (P, C), got shape {tuple(feats.shape)}")
    p, c = feats.shape
    s = start.shape[0] - 1
    feats = feats.contiguous()
    nvcc.check("feats", feats, torch.float32, (p, c), dev)
    nvcc.check("start", start, torch.int32, (s + 1,), dev)
    lib = build()
    if not 1 <= c <= lib.ppk_patch_reduce_max_cols():
        raise ValueError(f"KR sums 1..{lib.ppk_patch_reduce_max_cols()} columns, not {c}")
    out = torch.empty((s, c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ppk_patch_reduce(feats.data_ptr(), start.data_ptr(), s, c, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"per-patch sum kernel KR launch failed: CUDA error {rc}")
    patch_reduce_kernel.launches += 1
    return out


# Launches of the CUDA kernel (plain-version calls do not count).
patch_reduce_kernel.launches = 0
