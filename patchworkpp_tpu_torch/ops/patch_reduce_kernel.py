"""The per-patch sum kernel KR: the unfused engine's ``ops.patch_reduce``,
and its moment mode ``ops/onehot.py:patch_moment_sums``, each as one call
of two CUDA launches.

No TPU kernel is replaced: the JAX package's per-patch sum is XLA
(``patchworkpp_tpu/ops/onehot.py:patch_reduce``). The source is
``csrc/patch_reduce.cu``, built by ``ops/nvcc.py`` at the first call. Its
plain version is ``ops/onehot.py:patch_reduce_reference`` (of
``masked_moment_features_cols`` in the moment mode), which it equals bit
for bit: each patch's rows in 128-row chunks, each chunk summed in
``ops.tree_sum``'s order, the chunk sums added in order from +0.0. The
first launch sums every chunk of the call (one warp a chunk, the map from a
global chunk to its patch computed on the card from ``start``), the second
folds each patch's chunk sums in order; the call reads nothing back to the
host, so a captured frame can hold it (the plain version reads the longest
patch's chunk count to the host).

``ops/onehot.py:patch_reduce`` and ``patch_moment_sums`` run these on a
CUDA tensor and the plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from patchworkpp_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "patch_reduce.cu"
CHUNK = 128
MOMENT_COLS = 10
# ppk_patch_reduce's parameters, in order:
# feats start num_rows num_patches cols partial chunks out stream
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
# ppk_patch_moments's: qx qy qz mask start num_rows num_patches partial chunks out stream
MOMENT_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p)
# ppk_patch_reduce_launches's: host reset
LAUNCH_ARGTYPES = (ctypes.c_void_p, ctypes.c_int)
# the kernels' own launch counters, in the source's order
LAUNCH_COUNTERS = ("kr_chunk_sums", "kr_moment_sums", "kr_fold generic", "kr_fold moments")


def max_chunks(num_rows: int, num_patches: int) -> int:
    """The most 128-row chunks ``num_patches`` patches of ``num_rows`` rows
    can have (each patch cut from its first row): the sum over patches of
    ceil(n_s / 128) is at most (P + 127 S) / 128. The kernel's grid and its
    scratch are sized by it, from the shapes alone."""
    return (num_rows + (CHUNK - 1) * num_patches) // CHUNK


@functools.lru_cache(maxsize=1)
def build() -> ctypes.CDLL:
    """Compile csrc/patch_reduce.cu (once per source content), load it and
    declare its entries."""
    lib = nvcc.build(SOURCE, "ppk_patch_reduce", ARGTYPES)
    lib.ppk_patch_moments.argtypes = list(MOMENT_ARGTYPES)
    lib.ppk_patch_moments.restype = ctypes.c_int
    lib.ppk_patch_reduce_max_cols.argtypes = []
    lib.ppk_patch_reduce_max_cols.restype = ctypes.c_int
    lib.ppk_patch_reduce_launches.argtypes = list(LAUNCH_ARGTYPES)
    lib.ppk_patch_reduce_launches.restype = ctypes.c_int
    return lib


def kernel_launches(reset: bool = False) -> dict:
    """KR's launches as its kernels counted them on the card (each grid's
    first thread adds one; a replayed graph's launches count too), by
    LAUNCH_COUNTERS, since the library was loaded or last reset; ``reset``
    zeroes them after the read. Waits for the device."""
    counts = (ctypes.c_ulonglong * len(LAUNCH_COUNTERS))()
    rc = build().ppk_patch_reduce_launches(ctypes.cast(counts, ctypes.c_void_p), int(reset))
    if rc != 0:
        raise RuntimeError(f"per-patch sum kernel KR: reading its launch counts failed: CUDA "
                           f"error {rc}")
    return dict(zip(LAUNCH_COUNTERS, (int(c) for c in counts)))


def build_log() -> str:
    """nvcc's output for the current source (after :func:`build`)."""
    return nvcc.build_log(SOURCE)


def _on_cuda(t: torch.Tensor, fn: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the per-patch sum kernel KR runs on CUDA tensors, not {t.device}; on "
                         f"the CPU ops/onehot.py:{fn} runs patch_reduce_reference")
    return t.device


def _scratch(p: int, s: int, c: int, dev: torch.device):
    """The chunk sums (max_chunks, C) and the output (S, C)."""
    return (torch.empty((max_chunks(p, s), c), dtype=torch.float32, device=dev),
            torch.empty((s, c), dtype=torch.float32, device=dev))


def _count(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"per-patch sum kernel KR ({what}) launch failed: CUDA error {rc}")
    patch_reduce_kernel.launches += 1


def patch_reduce_kernel(feats: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """(S, C) per-patch sums of ``feats`` (P, C) f32 over the row runs
    ``[start[s], start[s+1])`` of ``start`` (S+1,) int32 (nondecreasing,
    within [0, P]), on the card: one call (two launches) on the current
    stream, counted in ``patch_reduce_kernel.launches``; a table wider than
    the kernel's 32 columns is one call a 32-column slice.

    Raises on a tensor that is not on a CUDA device (the CPU runs
    ``ops/onehot.py:patch_reduce_reference``), on a dtype, shape or device it
    does not take, and on a failed build or launch."""
    dev = _on_cuda(feats, "patch_reduce")
    if feats.dim() != 2:
        raise ValueError(f"feats must be (P, C), got shape {tuple(feats.shape)}")
    p, c = feats.shape
    s = start.shape[0] - 1
    feats = feats.contiguous()
    nvcc.check("feats", feats, torch.float32, (p, c), dev)
    nvcc.check("start", start, torch.int32, (s + 1,), dev)
    lib = build()
    widest = lib.ppk_patch_reduce_max_cols()
    if c > widest:  # a wider table: one call a slice of columns (each column's sum is its own)
        return torch.cat([patch_reduce_kernel(feats[:, i:i + widest], start)
                          for i in range(0, c, widest)], dim=1)
    if c < 1:
        raise ValueError(f"KR sums at least one column, not {c}")
    partial, out = _scratch(p, s, c, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count(lib.ppk_patch_reduce(feats.data_ptr(), start.data_ptr(), p, s, c, partial.data_ptr(),
                                partial.shape[0], out.data_ptr(), stream), "generic mode")
    return out


def patch_moment_sums_kernel(qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
                             mask_f: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """KR's moment mode: (S, 10) per-patch sums of the masked monomials
    ``ops/moments.py:masked_moment_features_cols(qx, qy, qz, mask_f)``,
    formed on the card from the (P,) f32 columns, over the row runs of
    ``start`` (S+1,) int32. One call (two launches) on the current stream,
    counted in ``patch_reduce_kernel.launches`` (KR's calls in either mode)
    and in ``patch_moment_sums_kernel.launches``. Raises as
    :func:`patch_reduce_kernel` does."""
    dev = _on_cuda(qx, "patch_moment_sums")
    p = qx.shape[0]
    s = start.shape[0] - 1
    cols = [t.contiguous() for t in (qx, qy, qz, mask_f)]
    for name, t in zip(("qx", "qy", "qz", "mask_f"), cols):
        nvcc.check(name, t, torch.float32, (p,), dev)
    nvcc.check("start", start, torch.int32, (s + 1,), dev)
    lib = build()
    partial, out = _scratch(p, s, MOMENT_COLS, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _count(lib.ppk_patch_moments(*(t.data_ptr() for t in cols), start.data_ptr(), p, s,
                                 partial.data_ptr(), partial.shape[0], out.data_ptr(), stream),
           "moment mode")
    patch_moment_sums_kernel.launches += 1
    return out


# Calls of the CUDA kernel (plain-version calls do not count): KR's calls in
# either mode, and the moment mode's alone.
patch_reduce_kernel.launches = 0
patch_moment_sums_kernel.launches = 0
