"""Port of ``distriflow_tpu/obs/jax_hooks.py``: the device-memory
watermark.

``device_peak_bytes`` (gauge, labelled ``device="cuda:<i>"``) is the
CUDA caching allocator's high-water mark for each visible card,
``torch.cuda.memory_stats(i)["allocated_bytes.all.peak"]`` (what
``torch.cuda.max_memory_allocated(i)`` reads; the counterpart of XLA's
``peak_bytes_in_use``), refreshed by a snapshot-time sampler. A process
without CUDA has no card to read: the gauge is absent there, as JAX's is
on a CPU backend. JAX's ``jit_recompiles_total`` has no counterpart: the
port compiles nothing at run time.

``install_cuda_hooks`` is idempotent per telemetry object.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

_INSTALLED_ATTR = "_cuda_hooks_installed"


def _sample_device_memory(telemetry: Any) -> None:
    """Refresh the per-card peak-memory gauges (nothing without CUDA)."""
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        peak = torch.cuda.memory_stats(i).get("allocated_bytes.all.peak")
        if peak is None:  # the allocator has not been used on this card
            continue
        telemetry.gauge(
            "device_peak_bytes", device=f"cuda:{i}",
            help="peak accelerator memory in use, per device",
        ).set(float(peak))


def install_cuda_hooks(telemetry: Optional[Any] = None) -> bool:
    """Register the memory sampler on ``telemetry`` (the process-global
    one by default). Idempotent per telemetry object; returns True when
    the hook is (already) installed, False on a disabled telemetry."""
    if telemetry is None:
        from distriflow_tpu_torch.obs.telemetry import get_telemetry
        telemetry = get_telemetry()
    if not getattr(telemetry, "enabled", False):
        return False
    if getattr(telemetry, _INSTALLED_ATTR, False):
        return True
    telemetry.register_sampler(lambda: _sample_device_memory(telemetry))
    setattr(telemetry, _INSTALLED_ATTR, True)
    return True
