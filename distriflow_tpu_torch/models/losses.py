"""Port of ``distriflow_tpu/models/losses.py``: the loss and metric registry.

Every loss is defined per example and reduced by an (optionally weighted)
mean; a weight of 0 marks a padding row. The math runs in f32, as in the
JAX package. The losses JAX takes from optax (``softmax_cross_entropy``,
``sparse_softmax_cross_entropy``, ``cosine_distance``, ``huber_loss``,
``sigmoid_cross_entropy``) are written here to optax's formulas.

The fused losses (``fused_softmax_cross_entropy``,
``fused_sparse_softmax_cross_entropy``) live in the kernel layer:
:func:`get_loss` imports :mod:`distriflow_tpu_torch.ops.fused_ce`, which
registers them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

# per-example form: (preds/logits, targets) -> (batch,) losses
PerExampleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# reduced form: (preds, targets, weight=None) -> scalar
LossFn = Callable[..., torch.Tensor]


def _flat2(v: torch.Tensor) -> torch.Tensor:
    """Collapse non-batch dims -> (batch, features)."""
    return v.reshape(v.shape[0], -1)


def _weighted_mean(per_example: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return per_example.mean()
    weight = torch.as_tensor(weight, device=per_example.device).to(per_example.dtype)
    if weight.dim() < per_example.dim():  # e.g. [B] weights over [B, S] token losses
        weight = weight.reshape(weight.shape + (1,) * (per_example.dim() - weight.dim()))
    weight = torch.broadcast_to(weight, per_example.shape)
    return (per_example * weight).sum() / torch.clamp(weight.sum(), min=1e-9)


def absolute_difference_per_example(preds, targets):
    return (_flat2(preds) - _flat2(targets)).abs().mean(-1)


def mean_squared_error_per_example(preds, targets):
    return (_flat2(preds) - _flat2(targets)).square().mean(-1)


def cosine_distance_per_example(preds, targets):
    """``optax.cosine_distance`` (epsilon 0): 1 - cosine similarity."""
    a, b = _flat2(preds), _flat2(targets)
    a_unit = a / a.square().sum(-1, keepdim=True).sqrt()
    b_unit = b / b.square().sum(-1, keepdim=True).sqrt()
    return 1.0 - (a_unit * b_unit).sum(-1)


def hinge_loss_per_example(preds, targets):
    # targets in {0,1} (tfjs convention); map to {-1,+1}
    signs = 2.0 * _flat2(targets) - 1.0
    return torch.clamp(1.0 - signs * _flat2(preds), min=0.0).mean(-1)


def huber_loss_per_example(preds, targets):
    """``optax.huber_loss`` with delta 1, averaged over features."""
    err = (_flat2(preds) - _flat2(targets)).abs()
    quadratic = torch.clamp(err, max=1.0)
    return (0.5 * quadratic.square() + (err - quadratic)).mean(-1)


def log_loss_per_example(preds, targets):
    eps = 1e-7
    p = torch.clamp(_flat2(preds), eps, 1.0 - eps)
    t = _flat2(targets)
    return (-t * torch.log(p) - (1.0 - t) * torch.log(1.0 - p)).mean(-1)


def sigmoid_cross_entropy_per_example(logits, targets):
    """``optax.sigmoid_binary_cross_entropy``, averaged over features."""
    x, t = _flat2(logits), _flat2(targets).to(logits.dtype)
    return (-t * F.logsigmoid(x) - (1.0 - t) * F.logsigmoid(-x)).mean(-1)


def softmax_cross_entropy_per_example(logits, targets):
    """``optax.softmax_cross_entropy`` over the last axis, in f32."""
    return -(targets * torch.log_softmax(logits.float(), dim=-1)).sum(-1)


def sparse_softmax_cross_entropy_per_example(logits, targets):
    """``optax.softmax_cross_entropy_with_integer_labels`` in f32: integer
    ``targets`` shaped like the logits' leading dims; ``lse - x[label]``.
    Like optax's ``take_along_axis``, a negative label counts from the end."""
    x = logits.float()
    v = x.shape[-1]
    lab = targets.long()
    lab = torch.where(lab < 0, lab + v, lab)
    label_logits = torch.gather(x, -1, lab[..., None])[..., 0]
    return torch.logsumexp(x, dim=-1) - label_logits


def vocab_parallel_sparse_ce_per_example(logits, targets, mesh, axis: str = "model"):
    """The sparse CE of logits sharded on the vocabulary over ``axis``
    (each rank holds its ``V/n`` slice; Megatron's vocab-parallel CE, what
    GSPMD makes of JAX's sparse CE there): the row max and the sum of
    exponentials are all-reduced over the axis, and the label's logit is
    taken by the rank holding it. Equals
    :func:`sparse_softmax_cross_entropy_per_example` of the full logits,
    on every rank; its gradient is this rank's vocabulary slice of the
    full gradient."""
    from distriflow_tpu_torch.parallel.collectives import pmax, psum
    from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size

    x = logits.float()
    vl = x.shape[-1]
    v0 = axis_index(mesh, axis) * vl
    lab = targets.long()
    lab = torch.where(lab < 0, lab + vl * axis_size(mesh, axis), lab)
    m = pmax(x.detach().amax(-1), axis, mesh)
    sumexp = psum(torch.exp(x - m[..., None]).sum(-1), axis, mesh)
    here = (lab >= v0) & (lab < v0 + vl)
    picked = torch.gather(x, -1, (lab - v0).clamp(0, vl - 1)[..., None])[..., 0]
    label_logits = psum(torch.where(here, picked, torch.zeros_like(picked)), axis, mesh)
    return torch.log(sumexp) + m - label_logits


def vocab_parallel_argmax(logits, mesh, axis: str = "model"):
    """The index of the largest logit over the full vocabulary from the
    vocab-sharded ``logits`` (the lowest index among equal maxima, as
    ``argmax`` takes it)."""
    from distriflow_tpu_torch.parallel.collectives import pmax, pmin
    from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size

    vl = logits.shape[-1]
    local_max, local_idx = logits.float().max(-1)
    m = pmax(local_max, axis, mesh)
    big = vl * axis_size(mesh, axis)
    cand = torch.where(local_max == m, local_idx + axis_index(mesh, axis) * vl,
                       torch.full_like(local_idx, big))
    return pmin(cand, axis, mesh)


PER_EXAMPLE: Dict[str, PerExampleFn] = {
    "absolute_difference": absolute_difference_per_example,
    "mean_squared_error": mean_squared_error_per_example,
    "cosine_distance": cosine_distance_per_example,
    "hinge_loss": hinge_loss_per_example,
    "huber_loss": huber_loss_per_example,
    "log_loss": log_loss_per_example,
    "sigmoid_cross_entropy": sigmoid_cross_entropy_per_example,
    "softmax_cross_entropy": softmax_cross_entropy_per_example,
    "sparse_softmax_cross_entropy": sparse_softmax_cross_entropy_per_example,
}


def _reduced(per_example: PerExampleFn) -> LossFn:
    def loss(preds, targets, weight=None):
        return _weighted_mean(per_example(preds, targets), weight)

    return loss


LOSSES: Dict[str, LossFn] = {name: _reduced(fn) for name, fn in PER_EXAMPLE.items()}

# convenience module-level reduced forms
absolute_difference = LOSSES["absolute_difference"]
mean_squared_error = LOSSES["mean_squared_error"]
cosine_distance = LOSSES["cosine_distance"]
hinge_loss = LOSSES["hinge_loss"]
huber_loss = LOSSES["huber_loss"]
log_loss = LOSSES["log_loss"]
sigmoid_cross_entropy = LOSSES["sigmoid_cross_entropy"]
softmax_cross_entropy = LOSSES["softmax_cross_entropy"]
sparse_softmax_cross_entropy = LOSSES["sparse_softmax_cross_entropy"]


def get_loss(name: str) -> LossFn:
    if name not in LOSSES and name.startswith("fused_"):
        # the fused losses live in the kernel layer; importing it registers them
        import distriflow_tpu_torch.ops.fused_ce  # noqa: F401

    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; registered: {sorted(LOSSES)}")
    return LOSSES[name]


def register_loss(name: str, fn: PerExampleFn) -> None:
    """Register a per-example loss."""
    PER_EXAMPLE[name] = fn
    LOSSES[name] = _reduced(fn)


# --- metrics -------------------------------------------------------------


def accuracy(logits: torch.Tensor, targets: torch.Tensor, weight=None) -> torch.Tensor:
    """Classification accuracy over one-hot OR integer targets (weight-aware)."""
    labels = targets if targets.dim() == logits.dim() - 1 else targets.argmax(-1)
    correct = (logits.argmax(-1) == labels).float()
    return _weighted_mean(correct, weight)


METRICS: Dict[str, LossFn] = {
    "accuracy": accuracy,
}


def get_metric(name: str) -> LossFn:
    if name not in METRICS:
        raise KeyError(f"unknown metric {name!r}; registered: {sorted(METRICS)}")
    return METRICS[name]
