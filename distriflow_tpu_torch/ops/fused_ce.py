"""Fused softmax cross-entropy: hand-written Hopper kernels and their plain
versions.

Port of ``distriflow_tpu/ops/fused_ce.py``. The loss reads the ``[N, V]``
logits once, in their own dtype, and never writes ``log_softmax`` (or, for
integer labels, a one-hot target) to device memory; the backward writes
``(softmax - target) * g`` straight into a gradient of the logits' dtype
from the saved per-row logsumexp.

``csrc/fused_ce.cu`` replaces the Pallas ``_fwd_kernel`` and
``_bwd_kernel`` in both their variants:

- ``sparse=True`` (integer labels, the LM loss): :func:`fused_ce_forward`
  and :func:`fused_ce_backward`;
- ``sparse=False`` (dense one-hot or soft targets, the MLP and ConvNet
  loss): :func:`fused_ce_dense_forward` and
  :func:`fused_ce_dense_backward`. Targets are f32 ``[N, V]``;
  :func:`fused_softmax_cross_entropy_per_example` widens bf16 and f16
  targets to f32 first (exactly), and the kernels refuse any other dtype.

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

from distriflow_tpu_torch.ops import build

NEG_INF = -1e30

_SIGNATURES = {
    "dftt_fused_ce_fwd_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dftt_fused_ce_bwd_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dftt_fused_ce_dense_fwd_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_void_p],
    "dftt_fused_ce_dense_bwd_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_void_p],
}
# target dtypes that widen to f32 exactly
_EXACT_TO_F32 = (torch.float16, torch.bfloat16, torch.float32)


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
    """Raise unless ``logits`` is contiguous bf16 ``[N, V]`` on CUDA and
    every row vector is a contiguous ``[N]`` tensor of its kernel dtype."""
    if logits.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.bfloat16 or not logits.is_contiguous():
        raise TypeError(f"{what}: the kernel takes contiguous bf16 [N, V] logits, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    n = logits.shape[0]
    for name, t in rows.items():
        want = torch.int32 if name == "labels" else torch.float32
        if t.shape != (n,) or t.dtype != want or not t.is_contiguous() or t.device != logits.device:
            raise ValueError(f"{what}: {name} must be contiguous {want} [{n}] on {logits.device}")


def fused_ce_forward(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(loss, lse)`` (f32) of ``[N, V]`` logits against ``[N]``
    int32 labels: the kernel on CUDA, the plain version on the CPU."""
    if logits.device.type == "cpu":
        return fused_ce_forward_reference(logits, labels)
    _check_rows("fused_ce_forward", logits, labels=labels)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    lib = build.load("fused_ce", _SIGNATURES)
    rc = lib.dftt_fused_ce_fwd_bf16(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, v,
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_forward")
    fused_ce_forward.launches += 1
    return loss, lse


def fused_ce_backward(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """Gradient of the per-row losses against the logits, in their dtype,
    for the upstream per-row gradient ``g`` (f32 ``[N]``)."""
    if logits.device.type == "cpu":
        return fused_ce_backward_reference(logits, labels, lse, g)
    _check_rows("fused_ce_backward", logits, labels=labels, lse=lse, g=g)
    n, v = logits.shape
    grad = torch.empty_like(logits)
    lib = build.load("fused_ce", _SIGNATURES)
    rc = lib.dftt_fused_ce_bwd_bf16(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), grad.data_ptr(),
        n, v, torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_backward")
    fused_ce_backward.launches += 1
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
    dense targets: the kernel on CUDA (bf16 logits, f32 targets), the plain
    version on the CPU."""
    if logits.device.type == "cpu":
        return fused_ce_dense_forward_reference(logits, targets)
    _check_rows("fused_ce_dense_forward", logits)
    _check_targets("fused_ce_dense_forward", logits, targets)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    lib = build.load("fused_ce", _SIGNATURES)
    rc = lib.dftt_fused_ce_dense_fwd_bf16(
        logits.data_ptr(), targets.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, v,
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_dense_forward")
    fused_ce_dense_forward.launches += 1
    return loss, lse


def fused_ce_dense_backward(logits: torch.Tensor, targets: torch.Tensor, lse: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    """Gradient of the per-row dense losses against the logits, in their
    dtype, for the upstream per-row gradient ``g`` (f32 ``[N]``)."""
    if logits.device.type == "cpu":
        return fused_ce_dense_backward_reference(logits, targets, lse, g)
    _check_rows("fused_ce_dense_backward", logits, lse=lse, g=g)
    _check_targets("fused_ce_dense_backward", logits, targets)
    n, v = logits.shape
    grad = torch.empty_like(logits)
    lib = build.load("fused_ce", _SIGNATURES)
    rc = lib.dftt_fused_ce_dense_bwd_bf16(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(), grad.data_ptr(),
        n, v, torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(rc, "fused_ce_dense_backward")
    fused_ce_dense_backward.launches += 1
    return grad


#: kernel launches since the count was last set to 0
fused_ce_forward.launches = 0
fused_ce_backward.launches = 0
fused_ce_dense_forward.launches = 0
fused_ce_dense_backward.launches = 0


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

    for name, fn in (("fused_softmax_cross_entropy", fused_softmax_cross_entropy_per_example),
                     ("fused_sparse_softmax_cross_entropy",
                      fused_sparse_softmax_cross_entropy_per_example)):
        if name not in losses.LOSSES:
            losses.register_loss(name, fn)


register()
