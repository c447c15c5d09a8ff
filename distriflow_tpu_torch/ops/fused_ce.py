"""Fused softmax cross-entropy: hand-written Hopper kernels and their plain
versions.

Port of ``distriflow_tpu/ops/fused_ce.py``. The loss reads the ``[N, V]``
logits once, in their own dtype, and never writes ``log_softmax`` (or, for
integer labels, a one-hot target) to device memory; the backward writes
``(softmax - target) * g`` straight into a gradient of the logits' dtype
from the saved per-row logsumexp.

``csrc/fused_ce.cu`` replaces the Pallas ``_fwd_kernel`` and
``_bwd_kernel`` in both their variants, on bf16 or f32 logits (the JAX
kernels keep the logits' dtype, and so does the gradient here):

- ``sparse=True`` (integer labels, the LM loss): :func:`fused_ce_forward`
  and :func:`fused_ce_backward`;
- ``sparse=False`` (dense one-hot or soft targets, the MLP and ConvNet
  loss): :func:`fused_ce_dense_forward` and
  :func:`fused_ce_dense_backward`. Targets are f32 ``[N, V]``;
  :func:`fused_softmax_cross_entropy_per_example` widens bf16 and f16
  targets to f32 first (exactly), and the kernels refuse any other dtype.

Two launch layouts, chosen here by :func:`_row_tile`: a block of 256
threads a row for wide vocabularies (the LM's V 32000), and for V <= 256
(every dense-CE head of the port, V 10) a block of R rows, G lanes a row
(the backward loads and stores the [R, V] tile 16 bytes at a time).

Semantics kept from the JAX package that ``F.cross_entropy`` and optax do
not share: a label outside ``[0, V)`` matches no column, so that row's loss
is its lse and its gradient is the plain softmax (``fused_ce.py:469-479``);
mask such rows with ``weight``. In the dense variant a logit at or below
-1e30 (or -inf) adds nothing to ``sum(x * t)``, so a -inf logit with target
0 gives a finite loss, not NaN (``fused_ce.py:94-97``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version beside it for CPU tensors; each counts its launches. Both
loss names register in the port's loss registry on import, as
``register()`` does in JAX.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distriflow_tpu_torch.ops import build, flop_count

NEG_INF = -1e30

# pointers, then N, V, lanes, rows, aligned, then the stream; each entry
# at bf16 and f32 logits
_SIGNATURES = {
    f"{name}_{tag}": [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name, n_ptrs in (("dftt_fused_ce_fwd", 4), ("dftt_fused_ce_bwd", 5),
                         ("dftt_fused_ce_dense_fwd", 4), ("dftt_fused_ce_dense_bwd", 5))
    for tag in ("bf16", "f32")
}
#: threads a block, in both layouts (``kThreads`` in ``csrc/fused_ce.cu``)
THREADS = 256
#: the widest row the narrow layout takes: 8 columns a lane, 32 lanes
NARROW_MAX_V = 256
# target dtypes that widen to f32 exactly
_EXACT_TO_F32 = (torch.float16, torch.bfloat16, torch.float32)
#: the logits dtypes the kernels take
LOGITS_DTYPE = frozenset({torch.bfloat16, torch.float32})
_TAG = {torch.bfloat16: "bf16", torch.float32: "f32"}
#: the loss names whose CUDA path runs these kernels (registered below)
LOSS_NAMES = ("fused_softmax_cross_entropy", "fused_sparse_softmax_cross_entropy")


def check_model(loss: str, device: Optional[torch.device], dtype: Optional[torch.dtype]) -> None:
    """Raise ``NotImplementedError`` when a model whose logits are ``dtype``
    on ``device`` would send them to these kernels under ``loss`` and they
    cannot take them; models call it when built, so that such a model fails
    there and not at its first step. Nothing is known (``None``) or the
    device is not CUDA: nothing to refuse."""
    if device is not None and torch.device(device).type == "cuda" and loss in LOSS_NAMES \
            and dtype is not None and dtype not in LOGITS_DTYPE:
        raise NotImplementedError(
            f"no CUDA fused cross-entropy kernel for {dtype} logits: it takes bf16 or f32; "
            f"set loss='{loss[len('fused_'):]}' for the plain loss")


def fused_ce_forward_reference(logits: torch.Tensor, labels: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(loss [N], lse [N])`` in f32
    from ``[N, V]`` logits and ``[N]`` integer labels."""
    x = logits.float()
    v = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    lab = labels.long()
    hit = torch.gather(x, 1, lab.clamp(0, v - 1)[:, None])[:, 0]
    hit = torch.where((lab >= 0) & (lab < v), hit, torch.zeros_like(hit))
    return lse - hit, lse


def fused_ce_backward_reference(logits: torch.Tensor, labels: torch.Tensor,
                                lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: ``(exp(x - lse) -
    onehot(label)) * g`` in the logits' dtype."""
    x = logits.float()
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((torch.exp(x - lse.float()[:, None]) - onehot) * g.float()[:, None]).to(logits.dtype)


def _check_rows(what: str, logits: torch.Tensor, **rows: torch.Tensor) -> None:
    """Raise unless ``logits`` is contiguous bf16 or f32 ``[N, V]`` on CUDA
    and every row vector is a contiguous ``[N]`` tensor of its kernel dtype."""
    if logits.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype not in LOGITS_DTYPE or not logits.is_contiguous():
        raise TypeError(f"{what}: the kernel takes contiguous bf16 or f32 [N, V] logits, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    n = logits.shape[0]
    for name, t in rows.items():
        want = torch.int32 if name == "labels" else torch.float32
        if t.shape != (n,) or t.dtype != want or not t.is_contiguous() or t.device != logits.device:
            raise ValueError(f"{what}: {name} must be contiguous {want} [{n}] on {logits.device}")


def _row_tile(v: int) -> Optional[Tuple[int, int]]:
    """The narrow layout's tile for rows of ``v`` columns: ``(lanes,
    rows)``, G lanes a row (the least power of two with 8 G >= v, so that
    a lane holds at most 8 columns) and R = 256 / G rows a block; ``None``
    above :data:`NARROW_MAX_V`, where a block takes one row. A tile's [R,
    v] logits are 512 v / G bytes (bf16) or 1024 v / G (f32), a multiple
    of 16 for every G <= 32: the backward loads and stores whole tiles 16
    bytes at a time
    wherever :func:`_aligned` holds (all but a partial tile's last chunk)."""
    if v > NARROW_MAX_V:
        return None
    lanes = 1
    while 8 * lanes < v:
        lanes *= 2
    return lanes, THREADS // lanes


def _entry(name: str, logits: torch.Tensor):
    """The C entry ``dftt_fused_ce_<name>`` built for the logits' dtype."""
    lib = build.load("fused_ce", _SIGNATURES)
    return getattr(lib, f"dftt_fused_ce_{name}_{_TAG[logits.dtype]}")


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's base lies on 16 bytes (a sliced view may
    not): only then do the kernels take the 16-byte loads and stores."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _tile_args(logits: torch.Tensor, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    """``(lanes, rows, aligned)`` of a launch over ``logits`` (rows 0: one
    block a row), ``tensors`` the launch's other [N, V] operands."""
    lanes, rows = _row_tile(logits.shape[1]) or (0, 0)
    return lanes, rows, int(_aligned(logits, *tensors))


def _record_cost(logits: torch.Tensor, backward: bool) -> None:
    """JAX's analytic cost of one CE pass (``_record_ce_cost``): one [N, V]
    stream, ~5 ops an element forward, ~3 backward; every wrapper records
    it, on either path."""
    n, v = logits.shape
    flop_count.record_kernel_cost(
        flops=(3 if backward else 5) * n * v,
        bytes_accessed=(2 if backward else 1) * n * v * logits.element_size(),
        transcendentals=n * v, category="fused_ce")


def fused_ce_forward(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(loss, lse)`` (f32) of ``[N, V]`` logits against ``[N]``
    int32 labels: the kernel on CUDA, the plain version on the CPU."""
    _record_cost(logits, backward=False)
    if logits.device.type == "cpu":
        return fused_ce_forward_reference(logits, labels)
    _check_rows("fused_ce_forward", logits, labels=labels)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    fn = _entry("fwd", logits)
    rc = fn(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, v,
        *_tile_args(logits), torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_forward")
    build.count_launch(fused_ce_forward, dtype=logits.dtype)
    return loss, lse


def fused_ce_backward(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Gradient of the per-row losses against the logits, in their dtype,
    for the upstream per-row gradient ``g`` (f32 ``[N]``)."""
    _record_cost(logits, backward=True)
    if logits.device.type == "cpu":
        return fused_ce_backward_reference(logits, labels, lse, g)
    _check_rows("fused_ce_backward", logits, labels=labels, lse=lse, g=g)
    n, v = logits.shape
    grad = torch.empty_like(logits)
    fn = _entry("bwd", logits)
    rc = fn(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), grad.data_ptr(),
        n, v, *_tile_args(logits, grad), torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_backward")
    build.count_launch(fused_ce_backward, dtype=logits.dtype)
    return grad


def fused_ce_dense_forward_reference(logits: torch.Tensor, targets: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense forward kernel: ``(loss [N], lse [N])``
    in f32 from ``[N, V]`` logits and targets, ``loss = lse - sum(where(x >
    -1e30, x, 0) * t)``."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    hit = (torch.where(x > NEG_INF, x, torch.zeros_like(x)) * targets.float()).sum(-1)
    return lse - hit, lse


def fused_ce_dense_backward_reference(logits: torch.Tensor, targets: torch.Tensor,
                                      lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the dense backward kernel: ``(exp(x - lse) - t) *
    g`` in the logits' dtype."""
    x = logits.float()
    return ((torch.exp(x - lse.float()[:, None]) - targets.float())
            * g.float()[:, None]).to(logits.dtype)


def _check_targets(what: str, logits: torch.Tensor, targets: torch.Tensor) -> None:
    if targets.shape != logits.shape or targets.dtype != torch.float32 \
            or not targets.is_contiguous() or targets.device != logits.device:
        raise TypeError(f"{what}: the kernel takes contiguous f32 targets shaped like the logits "
                        f"{tuple(logits.shape)}, got {targets.dtype} {tuple(targets.shape)}")


def fused_ce_dense_forward(logits: torch.Tensor, targets: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(loss, lse)`` (f32) of ``[N, V]`` logits against ``[N, V]``
    dense targets: the kernel on CUDA (bf16 or f32 logits, f32 targets), the plain
    version on the CPU."""
    _record_cost(logits, backward=False)
    if logits.device.type == "cpu":
        return fused_ce_dense_forward_reference(logits, targets)
    _check_rows("fused_ce_dense_forward", logits)
    _check_targets("fused_ce_dense_forward", logits, targets)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    fn = _entry("dense_fwd", logits)
    rc = fn(
        logits.data_ptr(), targets.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, v,
        *_tile_args(logits, targets), torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_dense_forward")
    build.count_launch(fused_ce_dense_forward, dtype=logits.dtype)
    return loss, lse


def fused_ce_dense_backward(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Gradient of the per-row dense losses against the logits, in their
    dtype, for the upstream per-row gradient ``g`` (f32 ``[N]``)."""
    _record_cost(logits, backward=True)
    if logits.device.type == "cpu":
        return fused_ce_dense_backward_reference(logits, targets, lse, g)
    _check_rows("fused_ce_dense_backward", logits, lse=lse, g=g)
    _check_targets("fused_ce_dense_backward", logits, targets)
    n, v = logits.shape
    grad = torch.empty_like(logits)
    fn = _entry("dense_bwd", logits)
    rc = fn(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(), grad.data_ptr(),
        n, v, *_tile_args(logits, targets, grad),
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_dense_backward")
    build.count_launch(fused_ce_dense_backward, dtype=logits.dtype)
    return grad


#: kernel launches since the count was last set to 0, also by logits dtype
for _fn in (fused_ce_forward, fused_ce_backward, fused_ce_dense_forward, fused_ce_dense_backward):
    _fn.launches = 0
    _fn.launches_by_dtype = {}
del _fn


class _SparseCE(torch.autograd.Function):
    """Per-row sparse CE with the saved lse as the backward's residual
    (JAX: ``_per_row_sparse_loss``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = fused_ce_forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_ce_backward(logits, labels, lse, g.float().contiguous()), None


def fused_sparse_softmax_cross_entropy_per_example(logits: torch.Tensor, targets: torch.Tensor
                                                   ) -> torch.Tensor:
    """Per-example integer-label CE (f32), shaped like the logits' leading
    dims. An out-of-range label matches no column (loss = lse)."""
    lead, v = logits.shape[:-1], logits.shape[-1]
    labels = targets.reshape(-1).to(torch.int32).contiguous()
    return _SparseCE.apply(logits.reshape(-1, v).contiguous(), labels).reshape(lead)


def fused_sparse_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean fused sparse CE (drop-in for
    ``losses.sparse_softmax_cross_entropy``)."""
    from distriflow_tpu_torch.models.losses import _weighted_mean

    return _weighted_mean(fused_sparse_softmax_cross_entropy_per_example(logits, targets), weight)


class _DenseCE(torch.autograd.Function):
    """Per-row dense CE with the saved lse as the backward's residual (JAX:
    ``_per_row_loss``'s ``custom_vjp``); the targets get no gradient, as in
    JAX."""

    @staticmethod
    def forward(ctx, logits, targets):
        loss, lse = fused_ce_dense_forward(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        return fused_ce_dense_backward(logits, targets, lse, g.float().contiguous()), None


def fused_softmax_cross_entropy_per_example(logits: torch.Tensor, targets: torch.Tensor
                                            ) -> torch.Tensor:
    """Per-example CE against dense (one-hot or soft) targets shaped like
    the logits: one f32 loss per row, shaped like the logits' leading
    dims. The kernels take f32 targets: f16 and bf16 targets are widened
    exactly, and on CUDA any other target dtype raises (the plain version
    on the CPU widens any)."""
    lead, v = logits.shape[:-1], logits.shape[-1]
    t = targets.detach().reshape(-1, v)
    if t.dtype in _EXACT_TO_F32 or t.device.type == "cpu":
        t = t.float()
    return _DenseCE.apply(logits.reshape(-1, v).contiguous(), t.contiguous()).reshape(lead)


def fused_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean dense fused CE (drop-in for
    ``losses.softmax_cross_entropy``)."""
    from distriflow_tpu_torch.models.losses import _weighted_mean

    return _weighted_mean(fused_softmax_cross_entropy_per_example(logits, targets), weight)


def register() -> None:
    from distriflow_tpu_torch.models import losses

    for name, fn in zip(LOSS_NAMES, (fused_softmax_cross_entropy_per_example,
                                     fused_sparse_softmax_cross_entropy_per_example)):
        if name not in losses.LOSSES:
            losses.register_loss(name, fn)


register()
