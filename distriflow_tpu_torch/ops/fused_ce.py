"""Fused softmax cross-entropy: hand-written Hopper kernels and their plain
versions.

Port of ``distriflow_tpu/ops/fused_ce.py``. The loss of an LM reads the
``[N, V]`` logits once, in their own dtype, and never writes
``log_softmax`` or a one-hot target to device memory; the backward writes
``(softmax - onehot) * g`` straight into a gradient of the logits' dtype
from the saved per-row logsumexp.

- ``csrc/fused_ce.cu`` replaces the Pallas ``_fwd_kernel`` and
  ``_bwd_kernel`` with ``sparse=True`` (integer labels): per-row loss and
  lse in f32, and the gradient.
- The dense-target variant (``sparse=False``: one-hot or soft targets,
  used by the MLP and ConvNet losses) is not ported yet:
  :func:`fused_softmax_cross_entropy` runs its plain version on CPU
  tensors and raises ``NotImplementedError`` on CUDA.

Semantics kept from the JAX package that ``F.cross_entropy`` and optax do
not share: a label outside ``[0, V)`` matches no column, so that row's loss
is its lse and its gradient is the plain softmax (``fused_ce.py:469-479``);
mask such rows with ``weight``.

:func:`fused_ce_forward` and :func:`fused_ce_backward` launch the kernels
for CUDA tensors (or raise) and run the plain versions beside them for CPU
tensors; each counts its launches. Both names register in the port's loss
registry on import, as ``register()`` does in JAX.
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
}


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


#: kernel launches since the count was last set to 0
fused_ce_forward.launches = 0
fused_ce_backward.launches = 0


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


def fused_softmax_cross_entropy_per_example(logits: torch.Tensor, targets: torch.Tensor
                                            ) -> torch.Tensor:
    """Per-example CE against dense (one-hot or soft) targets. The CUDA
    kernel of this variant is not ported yet: CPU tensors run the plain
    version (``lse - sum(x * t)``, differentiated by autograd into
    ``(softmax - t) * g``), CUDA tensors raise."""
    if logits.device.type != "cpu":
        raise NotImplementedError(
            "fused_softmax_cross_entropy (dense targets): the CUDA kernel is not ported yet")
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    return lse - (x * targets.detach().float()).sum(-1)


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
