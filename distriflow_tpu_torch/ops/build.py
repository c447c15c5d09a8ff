"""Build and load the port's CUDA kernels (no JAX counterpart: Pallas
kernels compile inside ``jax.jit``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Libraries land in ``csrc/build/`` (ignored by git), named by a
hash of the source, so an edited source rebuilds and an unchanged one
loads at once. :func:`build_all` starts one ``nvcc`` per source, all
together; a wrapper's first launch builds just its own library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: every kernel source of the port, ``csrc/<name>.cu``
SOURCES = ("flash_attention", "flash_decode", "flash_attention_bwd", "fused_ce", "depthwise_gn",
           "flash_attention_f32")
#: the headers each source includes (an edit to one rebuilds its sources)
HEADERS = {"flash_attention": ("common.cuh", "hopper.cuh"),
           "flash_attention_bwd": ("common.cuh", "hopper.cuh"),
           "flash_decode": ("common.cuh", "hopper.cuh"),
           "depthwise_gn": ("common.cuh", "hopper.cuh")}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas register/shared-memory report of each build, by source name
ptxas_reports: Dict[str, str] = {}
_count_lock = threading.Lock()


def count_launch(fn, head_dim: "int | None" = None, dtype=None) -> None:
    """Count one launch of ``fn``'s kernel in ``fn.launches`` and, for a
    kernel built at several head dims or element types, in
    ``fn.launches_by_head_dim`` and ``fn.launches_by_dtype`` (keyed by the
    dtype's name, ``"float32"``). The wrappers run on several threads at
    once (the wire-training clients fit in their transport's handler
    threads), and a bare ``+= 1`` on an attribute can lose an increment
    between threads: the lock keeps the count exact."""
    with _count_lock:
        fn.launches += 1
        for by, key in ((getattr(fn, "launches_by_head_dim", None), head_dim),
                        (getattr(fn, "launches_by_dtype", None),
                         None if dtype is None else str(dtype).replace("torch.", ""))):
            if by is not None and key is not None:
                by[key] = by.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        (CSRC / h).read_bytes() for h in HEADERS.get(name, ("common.cuh",)))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> "subprocess.Popen[str] | None":
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: "subprocess.Popen[str] | None") -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    ptxas_reports[name] = log
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every named source that is not built yet, all in parallel."""
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for n, p in procs:
            _finish(n, p)


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; ``signatures`` maps each C function to its ``argtypes`` (every
    function returns an ``int`` CUDA error code)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
