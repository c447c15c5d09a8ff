"""Port of ``distriflow_tpu/parallel/collectives.py``: the allreduce
latency probe (``collective_latency_us``). The JAX package's ``psum``,
``pmean``, gathers and ring permutes are not ported yet."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collective_latency_us(mesh, nbytes: int = 4 * 1024 * 1024, axis: str = "data",
                          iters: int = 10) -> float:
    """Measured allreduce latency (µs a call, the mean of ``iters`` after
    one warm-up) of an ``nbytes`` float32 buffer on each rank of
    ``mesh``'s ``axis``, on the mesh's device type."""
    group = mesh.get_group(axis)
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    x = torch.arange(nbytes // 4, dtype=torch.float32, device=device)
    dist.all_reduce(x, group=group)  # warm-up: communicator set-up
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(x, group=group)
    _sync(device)
    return (time.perf_counter() - start) / iters * 1e6
