"""Port of ``distriflow_tpu/parallel/distributed.py``: multi-process runtime
initialization.

JAX wires hosts into one system with ``jax.distributed.initialize``; the
port starts a ``torch.distributed`` process group, one process a rank.
The coordinator's address, the process count and this process's index
come from JAX's arguments or from the environment (``COORDINATOR_ADDRESS``,
else torch's usual ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``). The backend follows the placement (``mesh.backend_for``):
``nccl`` when each rank has a card of its own, ``gloo`` when ranks share
a card or run on the CPU. How many ranks share each card of this host is
the caller's ``ranks_per_device``, or this host's rank count
(``LOCAL_WORLD_SIZE``, as ``torchrun`` sets it) over its cards; with
neither, the ranks are taken to be one host's only when they fit one a
card, and more ranks than cards raise rather than guess. The group's
timeout is ``mesh.GROUP_TIMEOUT``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from distriflow_tpu_torch.parallel.mesh import GROUP_TIMEOUT, backend_for


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def placement(device_type: str, world: int, process_id: int, cards: int,
              ranks_per_device: Optional[int] = None, local_world: Optional[int] = None,
              local_rank: Optional[int] = None) -> Tuple[str, Optional[int]]:
    """``(backend, card)`` of rank ``process_id`` of ``world`` on a host
    with ``cards`` cards (``card`` None on the CPU): ranks
    ``ranks_per_device`` to a card (by default this host's
    ``local_world`` ranks over its cards, rounded up), in local-rank
    order."""
    if device_type != "cuda":
        return backend_for(device_type), None
    if cards < 1:
        raise ValueError("no CUDA device is visible")
    if ranks_per_device is None:
        if local_world is None:
            if world > cards:
                raise ValueError(
                    f"{world} ranks and {cards} cards on this host: pass ranks_per_device= "
                    "(ranks sharing a card) or set LOCAL_WORLD_SIZE (ranks on this host)")
            local_world = world
        ranks_per_device = -(-local_world // cards)
    if local_rank is None:
        local_rank = process_id % (cards * ranks_per_device)
    return backend_for(device_type, ranks_per_device), local_rank // ranks_per_device


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto_pod: bool = False,
    device: Union[str, torch.device, None] = None,
    ranks_per_device: Optional[int] = None,
) -> None:
    """Start the process group (idempotent; a no-op for one process).

    ``coordinator_address`` is ``host:port`` of rank 0's store;
    ``device`` (``cuda`` by default) is where this rank's tensors live;
    on ``cuda`` the card and the backend come from :func:`placement`
    (``ranks_per_device``: how many ranks share each card).
    ``auto_pod=True`` reads everything from torch's launcher variables
    (``torchrun``'s ``env://``)."""
    if dist.is_initialized():
        return
    from distriflow_tpu_torch.utils.device import resolve_device

    if coordinator_address is None and "COORDINATOR_ADDRESS" in os.environ:
        coordinator_address = os.environ["COORDINATOR_ADDRESS"]
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and num_processes is None and not auto_pod:
        return  # single process: nothing to wire up
    kind = resolve_device(device).type
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    if world is None or process_id is None:
        raise ValueError("initialize needs the process count and this process's index "
                         "(arguments, or WORLD_SIZE and RANK)")
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    backend, card = placement(kind, world, process_id, cards, ranks_per_device,
                              _env_int("LOCAL_WORLD_SIZE"), _env_int("LOCAL_RANK"))
    if card is not None:
        torch.cuda.set_device(card)
    init = "env://" if auto_pod and coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, rank=process_id, world_size=world,
                            timeout=GROUP_TIMEOUT)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Process 0 plays the reference's 'server' role for host-side work
    (checkpoint writes, logging, data dispatch)."""
    return process_index() == 0
