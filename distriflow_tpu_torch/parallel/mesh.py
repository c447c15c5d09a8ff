"""Port of ``distriflow_tpu/parallel/mesh.py``: mesh construction.

JAX lays every visible device of one process on a ``jax.sharding.Mesh``;
``torch.distributed`` runs one rank a card, so the port's mesh is a
``DeviceMesh`` over the process group's ranks on the one axis ``"data"``
(the reference-parity layout). Where no process group exists,
:func:`ensure_process_group` starts a single-process one (``nccl`` on
``cuda``, ``gloo`` on the CPU, over a ``HashStore``: world size 1), and
its caller tears it down with ``torch.distributed.destroy_process_group``
when it is done: the group lives for the process otherwise.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

AXES: Tuple[str, ...] = ("data",)

Device = Union[str, torch.device, None]


def _device_type(devices: Device) -> str:
    from distriflow_tpu_torch.utils.device import resolve_device

    return resolve_device(devices).type


def ensure_process_group(devices: Device = None) -> bool:
    """Start a single-process group for ``devices``' type (``cuda`` by
    default) unless one is up. Returns True when it started one: the
    caller then owns it and destroys it."""
    if dist.is_initialized():
        return False
    kind = _device_type(devices)
    if kind == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def create_mesh(config: Optional[Mapping[str, int]] = None, devices: Device = None):
    """A ``DeviceMesh`` with the axis ``"data"`` over the process group's
    ranks, one card (or CPU process) each, of ``devices``' type (``cuda``
    by default). ``config`` may name the axis size, which must equal the
    world size. Needs a process group (:func:`ensure_process_group`)."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = _device_type(devices)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call ensure_process_group() first")
    world = dist.get_world_size()
    sizes = dict(config or {"data": world})
    unknown = set(sizes) - set(AXES)
    if unknown:
        raise NotImplementedError(f"mesh axes {sorted(unknown)} are not ported yet")
    if sizes["data"] != world:
        raise ValueError(f"mesh axis sizes {sizes} multiply to {sizes['data']}, "
                         f"but the process group has {world} ranks")
    return DeviceMesh(kind, torch.arange(world), mesh_dim_names=AXES)


def data_parallel_mesh(devices: Device = None):
    """Every rank on the ``data`` axis: the reference-parity layout."""
    return create_mesh(None, devices)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, as ``dict(jax_mesh.shape)`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
