"""Device resolution for the port's entry points (no JAX counterpart:
JAX picks its backend globally, PyTorch takes a device per call).

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU and without an explicit CPU request they raise: the port never quietly
carries on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


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
