"""Port of ``distriflow_tpu/parallel/mesh.py``: mesh construction and batch
placement.

JAX lays every visible device of one process on a ``jax.sharding.Mesh``
and GSPMD inserts the collectives; ``torch.distributed`` is SPMD, one
process a rank, so the port's mesh is a five-axis ``DeviceMesh`` over the
process group's ranks with the JAX axis names (sizes of 1 are kept, as JAX
keeps them):

- ``data``   — data parallelism
- ``model``  — tensor/model parallelism (Megatron-style weight sharding)
- ``seq``    — sequence/context parallelism (ring or Ulysses attention)
- ``pipe``   — pipeline stages
- ``expert`` — MoE expert parallelism

Ranks are laid out row-major over ``(data, model, seq, pipe, expert)``,
as JAX's ``np.asarray(devices).reshape(shape)`` lays devices out, so rank
*r* holds the shard JAX's device *r* holds on the same mesh. Every axis's
sub-groups are made here with :data:`GROUP_TIMEOUT` (``DeviceMesh``'s own
would take the 30-minute default) and handed to
``DeviceMesh.from_group``.

Every rank calls the same code: each gets the *global* host batch, made
from the same seed, and :func:`shard_batch` returns its slice. A placement
(:class:`Placement`) is a value naming a mesh axis (or None) for each dim,
as a ``PartitionSpec`` does; tensors stay plain local tensors.

Where no process group exists, :func:`ensure_process_group` starts a
single-process one (``nccl`` on ``cuda``, ``gloo`` on the CPU, over a
``HashStore``: world size 1), and its caller tears it down with
``torch.distributed.destroy_process_group`` when it is done.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from distriflow_tpu_torch.utils.config import MeshConfig
from distriflow_tpu_torch.utils.serialization import batch_rows, tree_map

AXES: Tuple[str, ...] = ("data", "model", "seq", "pipe", "expert")
#: the timeout of every process group the port starts (gloo's default is
#: 30 minutes: a hung rank must fail its run, not stall it)
GROUP_TIMEOUT = timedelta(seconds=60)

Device = Union[str, torch.device, None]


def _device_type(devices: Device) -> str:
    from distriflow_tpu_torch.utils.device import resolve_device

    return resolve_device(devices).type


def backend_for(device_type: str, ranks_per_device: int = 1) -> str:
    """The collective backend for a placement: ``nccl`` when every rank
    has a card of its own (``ranks_per_device`` 1), ``gloo`` when ranks
    share a card or run on the CPU (NCCL refuses two ranks on one
    device)."""
    return "nccl" if device_type == "cuda" and ranks_per_device == 1 else "gloo"


def ensure_process_group(devices: Device = None) -> bool:
    """Start a single-process group for ``devices``' type (``cuda`` by
    default) unless one is up. Returns True when it started one: the
    caller then owns it and destroys it."""
    if dist.is_initialized():
        return False
    kind = _device_type(devices)
    if kind == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend_for(kind, 1), store=dist.HashStore(), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    return True


def create_mesh(config: Union[MeshConfig, Mapping[str, int], None] = None,
                devices: Device = None):
    """A five-axis ``DeviceMesh`` over the process group's ranks, of
    ``devices``' type (``cuda`` by default), with the axis sizes of
    ``config`` (a :class:`MeshConfig` or a mapping; None: every rank on
    ``data``). The sizes must multiply to the world size. Every rank must
    call it (it makes the axes' sub-groups). Needs a process group
    (:func:`ensure_process_group`, or ``parallel.distributed.initialize``)."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = _device_type(devices)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call ensure_process_group() first")
    world = dist.get_world_size()
    if config is None:
        config = MeshConfig(data=world)
    if isinstance(config, Mapping):
        config = MeshConfig(**dict(config))
    if config.size != world:
        raise ValueError(f"mesh axis sizes {config} multiply to {config.size}, "
                         f"but the process group has {world} ranks")
    shape = tuple(getattr(config, a) for a in AXES)
    ranks = torch.arange(world, dtype=torch.int).reshape(shape)
    me = dist.get_rank()
    mine = []
    for dim, size in enumerate(shape):
        own = None
        # every rank takes part in making every slice's group, in one order
        for sl in ranks.movedim(dim, -1).reshape(-1, size).tolist():
            g = dist.new_group(sl, timeout=GROUP_TIMEOUT)
            if me in sl:
                own = g
        mine.append(own)
    return DeviceMesh.from_group(mine, kind, mesh=ranks, mesh_dim_names=AXES)


def data_parallel_mesh(devices: Device = None):
    """Every rank on the ``data`` axis: the reference-parity layout."""
    return create_mesh(None, devices)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, as ``dict(jax_mesh.shape)`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX ``lax.axis_index``)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh axis (or None) for each dim of an array: JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))`` without the device
    buffers. Trailing dims past ``spec`` are replicated."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()

    def shard(self, x):
        """This rank's block of a global array or tensor (a view where
        slicing allows one)."""
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            n = axis_size(self.mesh, ax)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by "
                                 f"{ax}-axis size {n}")
            size = x.shape[dim] // n
            start = axis_index(self.mesh, ax) * size
            x = x.narrow(dim, start, size) if isinstance(x, torch.Tensor) else \
                np.take(x, np.arange(start, start + size), axis=dim)
        return x


def replicated(mesh) -> Placement:
    """Fully replicated (every rank holds the full array)."""
    return Placement(mesh, ())


def batch_sharding(mesh, axis: str = "data") -> Placement:
    """The leading (batch) dim sharded over ``axis``; the rest replicated."""
    return Placement(mesh, (axis,))


def _to_mesh_device(x, mesh) -> torch.Tensor:
    from distriflow_tpu_torch.utils.device import canonical_dtype

    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(x))
    return canonical_dtype(t).contiguous().to(mesh_device(mesh))


def is_local(t) -> bool:
    """True for a tensor :func:`shard_batch` made: this rank's slice
    already (the trainers take it as it is; JAX reads an array's
    sharding)."""
    return bool(getattr(t, "mesh_local", False))


def shard_batch(mesh, batch: Any, axis: str = "data", seq_axis: Optional[str] = None) -> Any:
    """This rank's slice of a global host batch (a tensor, array, or a
    tuple/list/dict of them): dim 0 sharded over ``axis``, replicated over
    the other axes, placed on the rank's device in the dtypes
    ``jax.device_put`` gives (float64 as float32, int64 as int32). With
    ``seq_axis`` (a model that runs sequence-sharded), dim 1 of every leaf
    of two or more dims is also sliced over that axis. Every tensor it
    returns carries ``mesh_local = True`` (:func:`is_local`)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b, axis, seq_axis) for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis, seq_axis) for k, v in batch.items()}
    if batch is None:
        return None
    if is_local(batch):
        return batch
    spec = (axis, seq_axis) if seq_axis is not None and np.ndim(batch) >= 2 else (axis,)
    t = _to_mesh_device(Placement(mesh, spec).shard(batch), mesh)
    t.mesh_local = True
    return t


def shard_batch_padded(mesh, x: Any, y: Any, axis: str = "data",
                       seq_axis: Optional[str] = None) -> Tuple[Any, Any, Any]:
    """Shard a possibly partial batch by zero-padding to the axis size:
    ``(x, y, weight)``, this rank's slices, ``weight`` 1.0 for real rows
    and 0.0 for padding, so weighted-mean losses stay exact."""
    x, y, weight = pad_partial_batch(axis_size(mesh, axis), x, y)
    if weight is None:
        weight = np.ones((batch_rows(x),), dtype=np.float32)
    return shard_batch(mesh, (x, y, weight), axis, seq_axis)


def pad_partial_batch(divisor: int, *arrays: Any) -> Tuple[Any, ...]:
    """Zero-pad every array's row count up to a multiple of ``divisor``.

    Returns ``(*padded_arrays, weight)``: ``weight`` is 1.0 for real rows
    and 0.0 for padding (so weighted-mean losses/metrics stay exact), or
    ``None`` when no padding was needed. An array may be a tuple of
    arrays (a model of several inputs or outputs): each is padded."""
    n = batch_rows(arrays[0])
    pad = (-n) % max(int(divisor), 1)
    if not pad:
        return (*arrays, None)

    def pad0(v):
        v = np.asarray(v)
        return np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))

    weight = np.concatenate([np.ones((n,), np.float32), np.zeros((pad,), np.float32)])
    return (*(tree_map(pad0, v) for v in arrays), weight)


def replicate(mesh, tree: Any) -> Any:
    """Every leaf of ``tree`` whole on this rank's device."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, t) for t in tree)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return _to_mesh_device(tree, mesh)


def local_batch_size(global_batch_size: int, mesh, axis: str = "data") -> int:
    n = axis_size(mesh, axis)
    if global_batch_size % n:
        raise ValueError(
            f"global batch size {global_batch_size} not divisible by {axis}-axis size {n}")
    return global_batch_size // n
