"""Device resolution for the port's entry points (no JAX counterpart:
JAX picks its backend globally, PyTorch takes a device per call).

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU and without an explicit CPU request they raise: the port never quietly
carries on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


#: the host dtypes ``jax.device_put`` narrows under JAX's default (x64 off)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def canonical_dtype(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype JAX would place it in: float64 becomes float32,
    int64 becomes int32, every other dtype stays (``t`` itself)."""
    want = _CANONICAL.get(t.dtype)
    return t if want is None else t.to(want)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); an explicit
    device is returned as a ``torch.device`` after the same check for
    CUDA devices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
