"""Port of ``distriflow_tpu/data/prefetch.py``: the host-side sampling
stream and device prefetch.

:func:`sampling_iterator` draws the same batches as the JAX package for
the same seed (numpy's ``RandomState``). :func:`prefetch_to_device` keeps
``size`` batches in flight: each host batch is staged in pinned memory and
copied with ``non_blocking=True`` on the current stream, so the next
batch's transfer overlaps the current step. Order is preserved. Arrays
are placed in the dtypes ``jax.device_put`` gives them (float64 as
float32, int64 as int32).
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from distriflow_tpu_torch.utils.device import canonical_dtype


def prefetch_to_device(iterator: Iterable[Any], device: Optional[Union[str, torch.device]] = None,
                       size: int = 2, mesh: Any = None) -> Iterator[Any]:
    """Yield device-resident batches, keeping ``size`` transfers in flight
    (``size=2`` is double buffering). ``iterator`` yields host batch
    tuples, lists or dicts of arrays; ``device`` is ``cuda`` by default.
    With a ``mesh`` each yielded batch is this rank's slice, batch-dim
    sharded over ``data`` (``parallel.mesh.shard_batch``, on the mesh's
    device: JAX's batch sharding); every rank iterates the same global
    batches."""
    from distriflow_tpu_torch.utils.device import resolve_device

    if size < 1:  # validate at the call site, not at first iteration
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if mesh is not None:
        from distriflow_tpu_torch.parallel.mesh import shard_batch

        return _prefetch(iterator, lambda b: shard_batch(mesh, b), size)
    dev = resolve_device(device)
    return _prefetch(iterator, lambda b: _place(b, dev), size)


def _place(batch: Any, device: torch.device) -> Any:
    if isinstance(batch, (tuple, list)):
        return type(batch)(_place(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _place(v, device) for k, v in batch.items()}
    t = batch if isinstance(batch, torch.Tensor) else torch.as_tensor(np.asarray(batch))
    t = canonical_dtype(t)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _prefetch(iterator: Iterable[Any], place, size: int) -> Iterator[Any]:
    buffer: collections.deque = collections.deque()
    for batch in iterator:
        buffer.append(place(batch))
        if len(buffer) >= size:
            yield buffer.popleft()
    while buffer:
        yield buffer.popleft()


def sampling_iterator(x: Any, y: Any, batch_size: int, steps: Optional[int] = None,
                      seed: int = 0) -> Iterator[Any]:
    """Uniform-sampling host batch stream: ``(x[idx], y[idx])`` with
    ``idx = RandomState(seed).randint(0, len(x), batch_size)`` per step."""
    rng = np.random.RandomState(seed)
    x, y = np.asarray(x), np.asarray(y)
    n = len(x)
    step = 0
    while steps is None or step < steps:
        idx = rng.randint(0, n, batch_size)
        yield x[idx], y[idx]
        step += 1


def to_uint8_wire(imgs: Any, labels: Any):
    """An image split in the wire-efficient form: uint8 pixels and int32
    labels (pair with ``with_uint8_inputs`` and a sparse loss). Expects raw
    [0, 255] pixels; float images that look normalized, or lie outside
    [0, 255], raise instead of being truncated or wrapped by the cast."""
    imgs = np.asarray(imgs)
    if np.issubdtype(imgs.dtype, np.floating):
        lo, hi = float(imgs.min()), float(imgs.max())
        if hi <= 1.0 + 1e-6:
            raise ValueError(
                f"to_uint8_wire got float images in [{lo:.3g}, {hi:.3g}] — "
                "looks normalized; casting to uint8 would zero them. Pass "
                "raw [0, 255] pixels (or multiply by 255 first).")
        if lo < 0 or hi > 255:
            raise ValueError(
                f"to_uint8_wire got float images in [{lo:.3g}, {hi:.3g}] — "
                "outside [0, 255]; uint8 cast would wrap. Rescale first.")
    return imgs.astype(np.uint8), np.asarray(labels).astype(np.int32)
