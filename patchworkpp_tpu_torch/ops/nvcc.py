"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled by nvcc for sm_90a into a shared library
with a plain C entry point, at the first call on a CUDA tensor, into
``build/`` beside the package (git-ignored), and loaded with ctypes. No
PyTorch header is compiled, so a build takes seconds. Builds of different
sources may run at the same time (one nvcc process each). Each build or
load is a ``kernels.build`` span of ``utils/profiling.py``, and each nvcc
run advances its counter ``kernels.compiles``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from patchworkpp_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# No fast math, no contraction: the kernels must round as their plain
# PyTorch versions do (separate multiplies and adds).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found: {source.name} is built at its first CUDA call")


def _library(source: Path) -> Path:
    """The library path for ``source``: its name carries a hash of the
    source and of the headers beside it, so an edited kernel (or a variant
    built from a copy with another header) is never served from a stale
    build."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build(source: Path, symbol: str, argtypes) -> ctypes.CDLL:
    """Compile ``source`` (once per content), load it and declare the C
    entry point ``symbol``: ``argtypes``, returning a CUDA error code.

    nvcc's output (the ``-Xptxas -v`` register and spill report) is kept
    beside the library as a ``.log`` (:func:`build_log`)."""
    with profiling.span("kernels.build", host_only=True):
        return _build(source, symbol, argtypes)


def _build(source: Path, symbol: str, argtypes) -> ctypes.CDLL:
    so = _library(source)
    if not so.exists():
        profiling.count("kernels.compiles")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(source), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib


def build_log(source: Path) -> str:
    """nvcc's output for the current ``source`` (after :func:`build`)."""
    log = _library(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise ValueError unless ``t`` has this device, dtype, shape and is
    contiguous (what a kernel's pointer arithmetic assumes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
