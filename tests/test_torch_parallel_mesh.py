"""The port's mesh and allreduce probe (``distriflow_tpu_torch/parallel``)
on the CPU: a single-process ``gloo`` world gives the mesh ``{"data": 1}``
(JAX's ``data_parallel_mesh`` over one device has data 1 as well), the
allreduce latency is positive, and the group the caller started is torn
down, leaving none for the next test. A two-process gloo world gives
``{"data": 2}``. A mesh has JAX's five axes (sizes of 1 kept); the size
check refuses axis sizes that do not multiply to the world size."""

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distriflow_tpu_torch.parallel import (
    AXES,
    collective_latency_us,
    create_mesh,
    data_parallel_mesh,
    ensure_process_group,
    mesh_shape,
)

pytestmark = pytest.mark.port


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():  # a failed test must not leak its group
        dist.destroy_process_group()


def test_single_process_mesh_and_allreduce(no_group):
    assert ensure_process_group("cpu") is True
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert ensure_process_group("cpu") is False  # one is up: not ours
        mesh = data_parallel_mesh("cpu")
        ones = {"data": 1, "model": 1, "seq": 1, "pipe": 1, "expert": 1}
        assert mesh_shape(mesh) == ones
        assert mesh.mesh_dim_names == AXES == ("data", "model", "seq", "pipe", "expert")
        us = collective_latency_us(mesh, nbytes=256 * 1024, iters=3)
        assert us > 0
        assert mesh_shape(create_mesh({"data": 1}, "cpu")) == ones
        with pytest.raises(ValueError, match="multiply to 2"):
            create_mesh({"data": 2}, "cpu")
        # every axis is ported now: a size-1 model axis is accepted
        assert mesh_shape(create_mesh({"data": 1, "model": 1}, "cpu")) == ones
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_mesh_needs_a_group(no_group):
    with pytest.raises(RuntimeError, match="no process group"):
        data_parallel_mesh("cpu")


def test_cuda_without_a_gpu_raises(no_group):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ensure_process_group()  # cuda by default
    assert not dist.is_initialized()


def _rank(rank, world, path, out):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=world)
    try:
        mesh = data_parallel_mesh("cpu")
        us = collective_latency_us(mesh, nbytes=64 * 1024, iters=2)
        x = torch.full((4,), float(rank + 1))
        dist.all_reduce(x, group=mesh.get_group("data"))
        with open(f"{out}.{rank}", "w") as f:
            f.write(f"{mesh_shape(mesh)['data']} {us > 0} {x[0].item()}")
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_world(tmp_path):
    out = str(tmp_path / "rank")
    mp.spawn(_rank, args=(2, str(tmp_path / "store"), out), nprocs=2, join=True)
    for r in range(2):
        with open(f"{out}.{r}") as f:
            assert f.read() == "2 True 3.0"
