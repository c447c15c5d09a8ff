"""Port of ``distriflow_tpu/parallel``: the mesh and the allreduce timing
the doctor drives. A mesh is a ``torch.distributed`` ``DeviceMesh`` with
the one axis ``"data"``, one rank a card; the JAX package's sharding
rules, pipeline schedules, ring and Ulysses attention and multi-host
runtime are not ported yet."""

from distriflow_tpu_torch.parallel.collectives import collective_latency_us
from distriflow_tpu_torch.parallel.mesh import (
    AXES,
    create_mesh,
    data_parallel_mesh,
    ensure_process_group,
    mesh_shape,
)

__all__ = [
    "AXES",
    "collective_latency_us",
    "create_mesh",
    "data_parallel_mesh",
    "ensure_process_group",
    "mesh_shape",
]
