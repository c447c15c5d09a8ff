"""Port of ``distriflow_tpu/utils/profiling.py``: the step timer and the
profiler trace.

JAX's ``device_timer`` leaves the wait to its caller (a ``float(loss)``
fetch blocks until the step is done). PyTorch also returns before the card
finishes, so this timer synchronizes the CUDA device itself before it reads
the clock at the end of the block: the time then includes every kernel the
block enqueued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def device_timer(device: Optional[Union[str, torch.device]] = None) -> Iterator[dict]:
    """Time a block including device completion. Yields a dict; read
    ``result['ms']`` after the block. On a CUDA ``device`` (or, with
    ``None``, whenever CUDA is available) the device is synchronized at the
    end of the block, before the clock is read."""
    result = {"ms": 0.0}
    dev = torch.device(device) if device is not None else None
    sync = (dev.type == "cuda") if dev is not None else torch.cuda.is_available()
    start = time.perf_counter()
    try:
        yield result
    finally:
        if sync:
            torch.cuda.synchronize(dev)
        result["ms"] = (time.perf_counter() - start) * 1e3


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op if None): host ops, and CUDA kernels when a GPU is visible,
    written as a Chrome/TensorBoard trace file when the block ends."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
