"""Tensor ops of the PyTorch port: the public names of the JAX package's
``ops`` (``__all__``), and the rounding helpers shared across the ops
(``f32``, ``div``, ``fma``, ``row_sum``, ...), which the submodules import
from here."""

from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float.

    Every literal that meets a float32 tensor goes through this, so that the
    tensor op sees the same constant as the JAX package's ``jnp.float32(v)``
    and as the CUDA source's ``vf`` literal, whatever precision the op is
    evaluated in (one op on two float32 values rounds the same either way)."""
    return float(np.float32(v))


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` for a constant ``c``, as XLA computes it: ``a`` times the
    float32 reciprocal of ``float32(c)``, rounded once on the host.

    XLA's algebraic simplifier rewrites a division by a constant into that
    multiply, so the JAX package's ``x / 10.0`` is ``x * float32(0.1)``.
    One float32 multiply by a float32 scalar rounds the same way on the CPU
    and on the card (PyTorch's own CUDA division by a Python scalar also
    multiplies by a reciprocal, but one it rounds itself)."""
    r = np.float32(1.0) / np.float32(c)
    return a * float(r)


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every subnormal value replaced by a zero of its sign.

    XLA:CPU runs with flush-to-zero, so a subnormal result of the JAX
    package's ``atan2`` reads as 0 in the next step (a point at (3, 3e-39)
    gets theta 0 and wraps to 2*pi, sector 15); glibc's ``atan2f``, and so
    ``ops/trig.py:atan2_f32``, return the subnormal itself. Flushing the
    result, not the operands, gives the JAX package's bins: with flushed
    operands a point at x = -1e-45 on the +y axis gets pi/2, where XLA
    keeps 1.5707962513. Three elementwise ops: ``t * 0`` keeps the sign,
    and NaN and infinities pass."""
    return t * (t.abs() >= 2.0**-126)


def fma(a, b, c) -> torch.Tensor:
    """Float32 ``a * b + c`` rounded once (a fused multiply-add), as
    XLA:CPU's x86 backend computes a multiply-add pair that it contracts
    and as the CUDA kernels' ``__fmaf_rn`` does.

    ``a * b`` is exact in float64 (24-bit factors); its float64 sum with
    ``c`` is made round-to-odd with a TwoSum error term, and round-to-odd
    at 53 bits then rounds to the correctly rounded float32 (Boldo and
    Melquiond, "Emulation of FMA and correctly rounded sums", IEEE TC
    2008). Separate tensor ops, so the same bits on every device. Any of
    the three may be a float32 tensor or a Python float (taken as float32);
    infinities and NaNs pass through as the float64 sum gives them."""
    ad = a.double() if isinstance(a, torch.Tensor) else f32(a)
    bd = ad if b is a else b.double() if isinstance(b, torch.Tensor) else f32(b)
    cd = c.double() if isinstance(c, torch.Tensor) else f32(c)
    p = ad * bd
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    # inexact and even: step to the odd neighbour on the exact sum's side
    # (a NaN error term, from an infinite sum, compares false both ways)
    fix = ((e > 0) | (e < 0)) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(fix, torch.nextafter(s, e * float("inf")), s).float()


def plane_dist(x, y, z, nx, ny, nz, d) -> torch.Tensor:
    """``((x*nx + y*ny) + z*nz) + d`` as XLA:CPU contracts it: the first
    add takes its left product into ``fma(x, nx, y*ny)``, the second its
    right one, the last add has no product."""
    return fma(z, nz, fma(x, nx, y * ny)) + d


def sq_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x*x + y*y`` in float32 as XLA:CPU computes it: contracted into
    ``fma(x, x, y*y)``, one rounding of the exact ``x*x`` plus ``y*y``."""
    return fma(x, x, y * y)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's CPU ``sqrt`` on large float32 (and float64) tensors is not
    correctly rounded (about 0.6% of random inputs are off by an ulp on an
    AVX-512 host), while CUDA's and the fit kernel's ``sqrtf`` are. The
    float64 root rounded to float32 is within one ulp of the right value;
    one exact test against the neighbouring midpoints, squared in float64
    (25-bit values, exact products), moves it to the correctly rounded one.
    """
    xd = x.double()
    s = torch.sqrt(xd).float()
    inf = torch.full_like(s, float("inf"))
    up, dn = torch.nextafter(s, inf), torch.nextafter(s, -inf)
    sd = s.double()
    hi = (sd + up.double()) * 0.5
    lo = (sd + dn.double()) * 0.5
    fix = (xd > 0) & (xd < float("inf"))  # positive and finite
    s = torch.where(fix & (xd > hi * hi), up, s)
    return torch.where(fix & (xd < lo * lo), dn, s)


ROW_WINDOW = 32


def seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one element after another, from 0:
    ``((0 + v0) + v1) + ...``, as XLA:CPU's loop adds a row shorter than
    its 32-wide windows (the JAX package's 20-slot LPR merge,
    ``parallel/point_sharded.py:merge_lpr_table``, rounds so)."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _windows(v: torch.Tensor) -> torch.Tensor:
    """One level of ``row_sum``: (..., n) -> (..., k, width) windows whose
    sums, each from 0 in order, are the level's sums (k == 1 and the row
    itself at the last level, n <= 32)."""
    n = v.shape[-1]
    if n <= ROW_WINDOW:
        return v[..., None, :]
    pad = -n % ROW_WINDOW
    lo, hi = pad // 2, pad - pad // 2
    if n + pad == 2 * ROW_WINDOW:
        # [v_0 .. v_(31-lo)] and [v_(32-lo) ..], the shorter one ended by 0
        if hi > lo:
            v = torch.nn.functional.pad(v, (0, hi - lo))
        return v.reshape(*v.shape[:-1], 2, -1)
    if pad:
        v = torch.nn.functional.pad(v, (lo, hi))
    return v.reshape(*v.shape[:-1], -1, ROW_WINDOW)


def row_sums(*vs: torch.Tensor) -> list:
    """``[row_sum(v) for v in vs]``, each level's windows of all the
    tensors summed in one sequence of adds: the windows are padded on the
    right with zeros to the widest and stacked, so a level costs the steps
    of its widest window, not their total. A trailing zero changes no bit
    (see ``row_sum``), and each window's sum is its own."""
    vs = list(vs)
    out = [None] * len(vs)
    while any(o is None for o in out):
        todo = [i for i, o in enumerate(out) if o is None]
        wins = [_windows(vs[i]) for i in todo]
        if len(wins) == 1:
            sums = [seq_sum(wins[0])]
        else:
            width = max(w.shape[-1] for w in wins)
            flat = torch.cat([
                torch.nn.functional.pad(w, (0, width - w.shape[-1])).reshape(-1, width)
                for w in wins])
            sums = [s.reshape(w.shape[:-1]) for s, w in
                    zip(seq_sum(flat).split([w[..., 0].numel() for w in wins]), wins)]
        for i, s in zip(todo, sums):
            if vs[i].shape[-1] <= ROW_WINDOW:
                out[i] = s[..., 0]
            else:
                vs[i] = s
    return out


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, of any length, in XLA:CPU's order.

    XLA:CPU's tree-reduction rewriter turns a row longer than 32 into a
    reduce-window of 32-wide windows: the row is padded with zeros to a
    multiple of 32, ``floor(pad / 2)`` on the left and the rest on the
    right, and each window is summed one element after another from 0.
    This repeats on the window sums until 32 or fewer are left, and those
    are summed one after another. Every loop adds its elements in order to
    an accumulator that starts at 0.

    So the JAX package's tile sums (``jnp.sum(..., axis=1)`` over a 128-lane
    tile in ops/tiled_fit.py) round as ``(((0 + w0) + w1) + w2) + w3`` with
    ``w = ((0 + v0) + v1) + ... + v31`` over each window; the fit kernels
    add a tile's rows in this order too. A (1064,) ring buffer of the
    adaptive state sums as 34 windows (12 zeros on each side), then 2
    windows of those (15 zeros on each side), then the 2 sums. Float32
    adds in a fixed order: the same bits on every device.

    A padding zero changes no bit of a sum from 0, before or after the
    values (the accumulator is never -0), so two windows are summed from
    their first value: 17 steps, not 32, for those 2 windows of 34 sums
    (each step is one tensor op, a node of a captured frame)."""
    return row_sums(v)[0]


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order.

    The axis is zero-padded to a power of two and halved in place
    (``v[..., :h] + v[..., h:]``) until one column is left, so a sum gives
    the same bits on every device; ``torch.sum`` leaves its order to the
    backend."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


# The public op surface of the JAX package's ops/__init__.py. Imported after
# the helpers above, which these submodules import from this package.
from patchworkpp_tpu_torch.ops.binning import PointBins, bin_points  # noqa: E402
from patchworkpp_tpu_torch.ops.eigen3 import eigh3x3_descending  # noqa: E402
from patchworkpp_tpu_torch.ops.moments import (  # noqa: E402
    masked_patch_moments,
    moment_features,
)
from patchworkpp_tpu_torch.ops.onehot import SPAD, patch_lookup, patch_reduce  # noqa: E402
from patchworkpp_tpu_torch.ops.segments import (  # noqa: E402
    patch_counts,
    segment_rank,
    sort_by_patch,
)

__all__ = [
    "bin_points",
    "PointBins",
    "sort_by_patch",
    "segment_rank",
    "patch_counts",
    "SPAD",
    "patch_lookup",
    "patch_reduce",
    "masked_patch_moments",
    "moment_features",
    "eigh3x3_descending",
]
