"""Port of ``distriflow_tpu/native``: the C++ host kernels, loaded with ctypes.

The wire path's two host-side hot loops, batch assembly (a row gather)
and federated aggregation (the mean over client buffers), run in
multi-threaded C++ (``src/distriflow_native.cpp``, the port's own copy of
the JAX package's source). It is compiled with ``g++`` at first use into
``distriflow_tpu_torch/csrc/build/`` (ignored by git), named by a hash of
the source, and loaded with ctypes. These are host kernels: without a
compiler the numpy paths run instead, with the JAX package's semantics,
and ``AVAILABLE`` stays False.

Public surface:
- :func:`gather_rows(src, idx)`: ``src[idx]`` into a fresh contiguous array;
- :func:`mean_buffers(bufs)`: elementwise float32 mean over equal-shape arrays;
- ``AVAILABLE`` / :func:`ensure_built`: introspection and explicit build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "distriflow_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c++17"]
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

AVAILABLE = False

_N_THREADS = min(8, os.cpu_count() or 1)


def _lib_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdistriflow_native-{digest}.so"


def _build(out: Path) -> bool:
    """Compile the shared library; returns success. Compiles to a
    per-process temp path, then renames into place (atomic), so a
    concurrent first use never maps half a file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        print(f"[native] build failed:\n{proc.stderr.decode()}", file=sys.stderr)
        return False
    os.replace(tmp, out)
    return True


def _load(path: Path) -> Optional[ctypes.CDLL]:
    global AVAILABLE
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.df_abi_version.restype = ctypes.c_int
    if lib.df_abi_version() != _ABI_VERSION:
        return None
    lib.df_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.df_mean_f32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    AVAILABLE = True
    return lib


def ensure_built(force: bool = False) -> bool:
    """Build (if needed) and load the native library; returns availability."""
    global _lib, _tried
    with _lock:
        if _lib is not None and not force:
            return True
        if _tried and not force:
            return False
        _tried = True
        path = _lib_path()
        if (force or not path.exists()) and not _build(path):
            return False
        _lib = _load(path)
        return _lib is not None


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` (leading-axis gather) into a fresh contiguous array."""
    src = np.asarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"index out of range for {len(src)} rows")
    # a strided view would need a full contiguous copy of the source to use
    # the C kernel; numpy fancy indexing copies only the batch rows instead
    if not ensure_built() or not src.flags["C_CONTIGUOUS"]:
        return np.ascontiguousarray(src[idx])
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    _lib.df_gather_rows(src.ctypes.data, row_bytes, idx.ctypes.data, len(idx),
                        out.ctypes.data, _N_THREADS)
    return out


def mean_buffers(bufs: Sequence[np.ndarray]) -> np.ndarray:
    """Elementwise float32 mean over equal-shape arrays (aggregation path):
    the C kernel sums in f32 in buffer order and multiplies by 1/N; the
    numpy path is ``np.mean`` over the stack."""
    if not bufs:
        raise ValueError("mean_buffers needs at least one buffer")
    arrs: List[np.ndarray] = [np.ascontiguousarray(b, np.float32) for b in bufs]
    shape = arrs[0].shape
    if any(a.shape != shape for a in arrs):
        raise ValueError("mean_buffers requires equal shapes")
    if not ensure_built():
        return np.mean(np.stack(arrs), axis=0, dtype=np.float32)
    out = np.empty(shape, np.float32)
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    _lib.df_mean_f32(ptrs, len(arrs), arrs[0].size, out.ctypes.data, _N_THREADS)
    return out
