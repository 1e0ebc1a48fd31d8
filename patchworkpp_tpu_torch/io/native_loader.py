"""ctypes wrapper for the native prefetching scan loader (port of
``patchworkpp_tpu/io/native_loader.py``, over the repo's
``native/loader.cpp``).

The native loader stages KITTI scans as fixed-capacity padded (capacity, 4)
float32 buffers on a prefetch thread, in scan order, so the host side of a
streaming loop is a buffer handoff instead of a per-frame read + pad in
Python. The port builds the library itself at first use: ``g++ -O2 -shared
-fPIC -pthread`` into ``build/`` beside the package (git-ignored), the
library named by a hash of the source, the way ``ops/nvcc.py`` builds the
CUDA kernels. :func:`available` reports whether it built; a loader on a
host where it cannot be built raises (there is no quiet fallback: the
caller picks :func:`~patchworkpp_tpu_torch.io.kitti.read_bin` +
:func:`~patchworkpp_tpu_torch.io.kitti.pad_cloud` instead).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _library() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libppk_loader_{h}.so"


def build() -> ctypes.CDLL:
    """Compile ``native/loader.cpp`` (once per content), load and bind it.
    Raises RuntimeError when the source, g++ or the build is missing."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        raise RuntimeError(f"native loader source not found: {SOURCE}")
    so = _library()
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native loader is built at first use")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def available() -> bool:
    """Whether the library is built, building it if it is not."""
    try:
        build()
    except RuntimeError:
        return False
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_void_p = ctypes.c_int, ctypes.c_void_p
    f_ptr = ctypes.POINTER(ctypes.c_float)
    lib.ppk_loader_create.restype = c_void_p
    lib.ppk_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int,
                                      c_int, c_int, c_int]
    lib.ppk_loader_acquire.restype = c_int
    lib.ppk_loader_acquire.argtypes = [c_void_p, ctypes.POINTER(f_ptr),
                                       ctypes.POINTER(c_int), ctypes.POINTER(c_int),
                                       ctypes.POINTER(c_int)]
    lib.ppk_loader_release.restype = c_int
    lib.ppk_loader_release.argtypes = [c_void_p, f_ptr]
    lib.ppk_loader_io_errors.restype = c_int
    lib.ppk_loader_io_errors.argtypes = [c_void_p]
    lib.ppk_loader_truncations.restype = c_int
    lib.ppk_loader_truncations.argtypes = [c_void_p]
    lib.ppk_loader_destroy.restype = None
    lib.ppk_loader_destroy.argtypes = [c_void_p]
    return lib


class NativeScanLoader:
    """Ordered, prefetched iteration over .bin scans as padded buffers.

    Yields (padded_view, npts, scan_index); the view is only valid until the
    next iteration (the slot is recycled), so copy it out first (the
    streaming bench copies it into a pinned tensor). With ``loop`` the
    paths repeat and the index keeps counting. An unreadable file yields
    npts 0 (``io_errors``); a scan longer than ``capacity`` is cut to it
    (``truncations``, ``last_truncated``).

    The loader runs one prefetch thread. ``native/loader.cpp`` lets a worker
    claim a scan index before it holds a free slot, so with several workers
    the slots can all fill with later scans while the worker holding the
    next one waits for a slot, and the consumer waits for that scan: a
    deadlock (seen within seconds in loop mode with 3 workers and 4 slots).
    One worker fills the slots in scan order and cannot wedge.
    """

    def __init__(self, paths: List[str], capacity: int, queue_depth: int = 4,
                 loop: bool = False) -> None:
        lib = build()
        self._lib = lib
        self.capacity = capacity
        self._paths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._handle = lib.ppk_loader_create(self._paths, len(paths), capacity,
                                             queue_depth, 1, int(loop))
        if not self._handle:
            raise RuntimeError("failed to create the native loader")
        self._held = None
        self.last_truncated = False

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int, int]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, int, int]:
        self._release_held()
        buf = ctypes.POINTER(ctypes.c_float)()
        npts, idx, trunc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.ppk_loader_acquire(self._handle, ctypes.byref(buf),
                                          ctypes.byref(npts), ctypes.byref(idx),
                                          ctypes.byref(trunc))
        if rc != 0:
            raise StopIteration
        self._held = buf
        self.last_truncated = bool(trunc.value)
        view = np.ctypeslib.as_array(buf, shape=(self.capacity, 4))
        return view, int(npts.value), int(idx.value)

    def _release_held(self) -> None:
        if self._held is not None:
            rc = self._lib.ppk_loader_release(self._handle, self._held)
            self._held = None
            if rc != 0:
                raise RuntimeError("ppk_loader_release rejected the held buffer "
                                   "(a foreign pointer)")

    @property
    def io_errors(self) -> int:
        """Unreadable files seen so far (their scans yield npts == 0)."""
        return int(self._lib.ppk_loader_io_errors(self._handle))

    @property
    def truncations(self) -> int:
        """Scans longer than ``capacity`` seen so far (staged with npts ==
        capacity, their tail dropped)."""
        return int(self._lib.ppk_loader_truncations(self._handle))

    def close(self) -> None:
        if self._handle:
            try:
                self._release_held()
            finally:
                self._lib.ppk_loader_destroy(self._handle)
                self._handle = None

    def __enter__(self) -> "NativeScanLoader":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
            return
        try:  # keep the with-body's exception as the one raised
            self.close()
        except RuntimeError:
            pass

    def __del__(self) -> None:
        try:
            self.close()
        except (RuntimeError, AttributeError):
            pass
