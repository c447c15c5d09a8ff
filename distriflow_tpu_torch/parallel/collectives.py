"""Port of ``distriflow_tpu/parallel/collectives.py``: collectives over a
mesh axis's sub-group.

JAX's collectives run inside ``shard_map`` and are named by axis; here
each takes the mesh too, and runs over this rank's group on that axis
(``mesh.get_group(axis)``; a sequence of axes reduces over each in turn).
Every collective GSPMD would insert implicitly is written explicitly by
the port's callers. Over an axis of size 1, or with no mesh (one device),
every collective returns its input and copies nothing.

The ones on a differentiated path are ``torch.autograd.Function``s whose
backward runs the transposed collective:

- :func:`psum` (all-reduce) ↔ identity, and :func:`copy_to` (identity) ↔
  all-reduce: Megatron's g/f pair. JAX's ``pvary`` has no torch
  counterpart; ``copy_to`` is what it stands for. A replicated value that
  each rank then consumes with its own shard (a column-parallel matmul's
  input) must pass through ``copy_to``, or its gradient stays this rank's
  part and never becomes the group's sum; a sum of rank partials that is
  replicated afterwards goes through ``psum``, whose backward leaves the
  (already replicated) gradient as it is.
- :func:`all_gather` ↔ :func:`reduce_scatter` (JAX's transpose pair);
  :func:`all_gather_invariant` (JAX ``lax.all_gather_invariant``) gathers
  into a replicated value, so its backward takes this rank's slice.
- :func:`ppermute_ring` (+shift) ↔ ppermute (−shift).
- :func:`all_to_all` (split a, concat b) ↔ all_to_all (split b, concat a).

**Host staging.** ``gloo`` is the backend where ranks share a card
(``mesh.backend_for``). Collectives of CUDA tensors over a ``gloo`` group
run here on a host copy: the tensor is copied to the CPU, the collective
runs there, the result is copied back. This is done for every collective
of a CUDA tensor on ``gloo``, never chosen by catching a failure, and
:data:`staged_bytes` counts the bytes copied each way by collective. The
compute stays on the card. (gloo's send and receive of a CUDA tensor abort
the process; its all-reduce, all-gather, reduce-scatter and all-to-all
take CUDA tensors, copying them to host memory inside gloo, uncounted:
torch 2.11 on an H100. One rule for every collective keeps every copy
counted.) ``gloo`` carries bf16 tensors as f32 (a move
is exact; a sum is taken in f32 and rounded once).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Sequence[str]]

#: bytes copied to and from the host for collectives of CUDA tensors over
#: gloo groups, by collective, since the count was last cleared
staged_bytes: Dict[str, int] = {}


def _axes(axis: AxisName):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _size(mesh, axis: str) -> int:
    """The axis's group size (1 with no mesh)."""
    return 1 if mesh is None else dist.get_world_size(mesh.get_group(axis))


def _staged(name: str, group, fn: Callable[..., torch.Tensor], *tensors: torch.Tensor
            ) -> torch.Tensor:
    """``fn(*tensors)`` on the tensors' device, or on host copies when
    CUDA tensors meet a gloo group (the result copied back)."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dist.get_backend(group) != "gloo":
        return fn(*tensors)
    if dtype == torch.bfloat16:  # gloo carries bf16 as f32: exact moves, f32 sums
        tensors = tuple(t.float() for t in tensors)
    if dev.type != "cuda":
        return fn(*tensors).to(dtype)
    host = [t.cpu() for t in tensors]
    out = fn(*host)
    staged_bytes[name] = (staged_bytes.get(name, 0)
                          + sum(t.numel() * t.element_size() for t in host)
                          + out.numel() * out.element_size())
    return out.to(dev).to(dtype)


def _ranks(group):
    return dist.get_process_group_ranks(group)


# -- plain collectives on one tensor --------------------------------------


def _all_reduce(x: torch.Tensor, mesh, axis: AxisName) -> torch.Tensor:
    return _all_reduce_op(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def _all_reduce_op(x: torch.Tensor, mesh, axis: AxisName, op, name: str) -> torch.Tensor:
    for ax in _axes(axis):
        if _size(mesh, ax) == 1:
            continue
        g = _group(mesh, ax)

        def run(t, g=g):
            t = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, op=op, group=g)
            return t

        x = _staged(name, g, run, x)
    return x


def pmax(x: torch.Tensor, axis: AxisName, mesh) -> torch.Tensor:
    """Max-allreduce over the axis (or axes); not differentiable (a
    stabilizer: the vocab-parallel CE's row max)."""
    return _all_reduce_op(x.detach(), mesh, axis, dist.ReduceOp.MAX, "pmax")


def pmin(x: torch.Tensor, axis: AxisName, mesh) -> torch.Tensor:
    """Min-allreduce over the axis (or axes); not differentiable."""
    return _all_reduce_op(x.detach(), mesh, axis, dist.ReduceOp.MIN, "pmin")


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if n == 1:
        return x
    g = _group(mesh, axis)

    def run(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim=dim)

    return _staged("all_gather", g, run, x)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if n == 1:
        return x
    g = _group(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} not divisible "
                         f"by {axis}-axis size {n}")

    def run(t):
        t = t.movedim(dim, 0).contiguous()
        out = torch.empty((t.shape[0] // n,) + t.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=g)
        return out.movedim(0, dim)

    return _staged("reduce_scatter", g, run, x)


def _ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    if _size(mesh, axis) == 1:
        return x
    g = _group(mesh, axis)
    ranks = _ranks(g)
    n = len(ranks)
    if n == 1 or shift % n == 0:
        return x
    me = ranks.index(dist.get_rank())

    def run(t):
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, ranks[(me + shift) % n], g),
               dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    return _staged("ppermute", g, run, x)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int, concat_axis: int
                ) -> torch.Tensor:
    n = _size(mesh, axis)
    if n == 1:
        return x
    g = _group(mesh, axis)
    shape = tuple(x.shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {shape} not divisible by "
                         f"{axis}-axis size {n}")

    def run(t):
        # chunk j of the split dim goes to rank j; what rank r sends lands
        # r-th along the concat dim (JAX all_to_all, tiled=True)
        parts = t.reshape(shape[:split_axis] + (n, shape[split_axis] // n)
                          + shape[split_axis + 1:]).movedim(split_axis, 0).contiguous()
        out = torch.empty_like(parts)
        dist.all_to_all_single(out, parts, group=g)
        y = out.movedim(0, concat_axis)
        merged = list(y.shape)
        merged[concat_axis:concat_axis + 2] = [n * y.shape[concat_axis + 1]]
        return y.reshape(merged)

    return _staged("all_to_all", g, run, x)


# -- differentiable collectives -------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.size, ctx.dim = x.shape[dim], dim
        ctx.start = mesh.get_local_rank(axis) * x.shape[dim]
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, -shift)
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None, None


def _tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def psum(tree: Any, axis: AxisName, mesh) -> Any:
    """Sum-allreduce every tensor of a tree over the mesh axis (or axes);
    the backward is the identity (Megatron's g)."""
    return _tree(lambda x: _Psum.apply(x, mesh, _axes(axis)), tree)


def pmean(tree: Any, axis: AxisName, mesh) -> Any:
    """Mean-allreduce over the axis (or axes)."""
    n = 1
    for ax in _axes(axis):
        n *= _size(mesh, ax)
    return _tree(lambda x: _Psum.apply(x, mesh, _axes(axis)) / n, tree)


def copy_to(x: torch.Tensor, axis: AxisName, mesh) -> torch.Tensor:
    """The identity whose backward sum-allreduces the gradient over the
    axis (Megatron's f; see the module docstring)."""
    return _CopyTo.apply(x, mesh, _axes(axis))


def all_gather(x: torch.Tensor, axis: str, mesh, *, gather_axis: int = 0) -> torch.Tensor:
    """Concatenate the axis's shards along ``gather_axis`` in rank order
    (JAX's ``tiled=True`` layout); the backward reduce-scatters the
    gradient (JAX's transpose)."""
    return _AllGather.apply(x, mesh, axis, gather_axis)


def all_gather_invariant(x: torch.Tensor, axis: str, mesh, *, gather_axis: int = 0
                         ) -> torch.Tensor:
    """:func:`all_gather` into a value replicated over the axis; the
    backward takes this rank's slice of the (replicated) gradient."""
    return _AllGatherInvariant.apply(x, mesh, axis, gather_axis)


def reduce_scatter(x: torch.Tensor, axis: str, mesh, *, scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the axis, each rank keeping its block of ``scatter_axis``
    (JAX ``psum_scatter``, tiled); the backward all-gathers."""
    return _ReduceScatter.apply(x, mesh, axis, scatter_axis)


def ppermute_ring(x: torch.Tensor, axis: str, mesh, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ``axis`` ring by ``shift``: rank i's block
    lands on rank i + shift (ring attention's move); the backward rotates
    the gradient back."""
    return _PPermute.apply(x, mesh, axis, shift)


def all_to_all(x: torch.Tensor, axis: str, mesh, *, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """JAX ``lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into
    axis-size chunks, chunk j sent to rank j, the received chunks
    concatenated along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def allreduce_mean(mesh, tree: Any, axis: str = "data") -> Any:
    """The mean over a leading dim sharded over ``axis``: each rank passes
    its ``[n, ...]`` block of every leaf; returns the global mean (JAX's
    jitted ``shard_map`` mean)."""
    n = _size(mesh, axis)

    def mean(v):
        return _all_reduce(v.sum(0), mesh, axis) / (v.shape[0] * n)

    return _tree(mean, tree)


def gather_ordered_sum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """The sum over the axis in rank order, r = 0 … n-1 (the same bits on
    every rank and across backends: an all-gather, then a local sum)."""
    n = _size(mesh, axis)
    if n == 1:
        return x
    parts = _all_gather(x.unsqueeze(0), mesh, axis, 0)
    out = parts[0].clone()
    for i in range(1, n):
        out.add_(parts[i])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_LATENCY_OPS = {
    "psum": lambda x, m, ax: _all_reduce(x, m, ax),
    "all_gather": lambda x, m, ax: _all_gather(x, m, ax, 0),
    "reduce_scatter": lambda x, m, ax: _reduce_scatter(x, m, ax, 0),
    "ppermute": lambda x, m, ax: _ppermute(x, m, ax, 1),
    "all_to_all": lambda x, m, ax: _all_to_all(x, m, ax, 0, 0),
}


def collective_latency_us(mesh, nbytes: int = 4 * 1024 * 1024, axis: str = "data",
                          iters: int = 10, collective: str = "psum") -> float:
    """Measured latency (µs a call, the mean of ``iters`` after one
    warm-up) of ``collective`` (``psum``, ``all_gather``,
    ``reduce_scatter``, ``ppermute``, ``all_to_all``) of an ``nbytes``
    float32 buffer on each rank of ``mesh``'s ``axis``, on the mesh's
    device type (host staging included where it applies)."""
    from distriflow_tpu_torch.parallel.mesh import mesh_device

    device = mesh_device(mesh)
    op = _LATENCY_OPS[collective]
    n = dist.get_world_size(_group(mesh, axis))
    elems = max(n, nbytes // 4 // n * n)
    x = torch.arange(elems, dtype=torch.float32, device=device)
    op(x, mesh, axis)  # warm-up: communicator set-up
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        op(x, mesh, axis)
    _sync(device)
    return (time.perf_counter() - start) / iters * 1e6
