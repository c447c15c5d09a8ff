"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``distriflow_tpu/ops/flash_attention.py``. Two kernels:

- ``csrc/flash_attention.cu`` replaces the Pallas ``_fwd_kernel``: causal
  or non-causal online-softmax attention over ``[B, H, S, D]`` bf16 tensors
  that never writes the ``[S, S]`` scores to device memory, returning O and
  the per-row logsumexp ``[B, H, S]`` f32 (plain, not the TPU kernel's
  128-lane replicated layout);
- ``csrc/flash_attention_bwd.cu`` replaces the fused backward
  ``_dkvq_kernel``: dK, dV and dQ from one P per tile pair. dQ is summed
  over K tiles with f32 atomics, so its summation order is not fixed from
  run to run. The two-kernel backward (``_dq_kernel``/``_dkv_kernel``,
  which JAX takes past 8 KV blocks of 1024) is not ported yet.

:func:`flash_attention` is differentiable: under autograd it goes through
:class:`_FlashAttention`, whose backward computes ``delta = rowsum(dO * O)``
(minus the lse cotangent) in f32 and calls :func:`flash_attention_backward`.
Each wrapper launches its kernel for CUDA tensors and runs its plain version
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`) for CPU tensors. The plain
versions keep the kernels' numeric contracts: scores from bf16 operands
accumulated in f32, masked scores at -1e30 with zero mass, P rounded to
the input dtype before each product it feeds, dS likewise, f32
accumulation, the 1/sqrt(D) scale applied once after each product.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from distriflow_tpu_torch.ops import build

NEG_INF = -1e30
BLOCK = 64  # query rows and key positions per tile in the kernel
SUPPORTED_HEAD_DIMS = (64,)  # the head dims the kernel is built and checked for

_SIGNATURES = {
    "dftt_flash_attention_fwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "dftt_flash_attention_bwd_bf16": [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
}


def flash_seq_supported(s: int, d: int, itemsize: int = 2) -> bool:
    """True when the kernel takes a prompt of length ``s`` at head dim
    ``d`` and element size ``itemsize``: bf16 and ``d`` in
    :data:`SUPPORTED_HEAD_DIMS`. Any ``s >= 1`` tiles (edges are masked)
    and the shared-memory footprint does not grow with ``s``."""
    return s >= 1 and itemsize == 2 and d in SUPPORTED_HEAD_DIMS


def _causal_keep(n: int, device) -> torch.Tensor:
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(O [B,H,S,D] in q's dtype,
    lse [B,H,S] f32)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (safe_m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: ``(dQ, dK, dV)`` in
    q's dtype from ``[B, H, S, D]`` q/k/v/dO, the forward's ``lse`` and
    ``delta = rowsum(dO * O)`` (both ``[B, H, S]`` f32). The numeric
    contract of the TPU kernel (``flash_attention.py:297-336``): P =
    ``exp(s * scale - lse)`` with masked pairs at exactly 0, P rounded to
    the input dtype before ``P^T dO``, dS = ``P (dP - delta)`` rounded to
    the input dtype before ``dS^T Q`` and ``dS K``, f32 sums, dK and dQ
    scaled once at the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    p = torch.exp(s - lse.float()[..., None])  # masked: exp(-1e30 - lse) == 0
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous bf16 [B, H, S, D] tensor
    shaped like ``ref`` on ref's CUDA device, at a (S, D) the kernels take."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    for name, t in tensors.items():
        if t.device != ref.device or t.shape != ref.shape or t.dim() != 4:
            raise ValueError(
                f"{what}: {name} must be [B, H, S, D] like q "
                f"{tuple(ref.shape)} on {ref.device}, got {tuple(t.shape)} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    _, _, s, d = ref.shape
    if not flash_seq_supported(s, d):
        raise ValueError(f"{what}: no kernel for S={s}, D={d}")


def _forward(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse: the kernel on CUDA tensors, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_kernel_inputs("flash_attention", q, q=q, k=k, v=v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention", _SIGNATURES)
    rc = lib.dftt_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` of attention from the forward's ``lse`` and ``delta
    = rowsum(dO * O)`` (minus any lse cotangent), both ``[B, H, S]`` f32.

    CPU tensors run :func:`flash_attention_backward_reference`. CUDA
    tensors launch the backward kernel or raise: q/k/v/dO contiguous bf16
    of one shape with ``D`` in :data:`SUPPORTED_HEAD_DIMS`, lse/delta
    contiguous f32. The kernel adds dQ over K tiles with f32 atomics into a
    zeroed buffer that is scaled and cast here."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do, lse, delta, causal)
    _check_kernel_inputs("flash_attention_backward", q, q=q, k=k, v=v, do=do)
    b, h, s, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} must be contiguous "
                             f"f32 [{b}, {h}, {s}] on {q.device}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    rc = lib.dftt_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        b * h, s, d, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return (dq_acc * scale).to(q.dtype), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Autograd around the two kernels (JAX: ``jax.custom_vjp``). The
    forward saves ``(q, k, v, o, lse)``; the backward folds the lse
    cotangent into delta (``dlse/ds = p``, ``flash_attention.py:553-560``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq, dk, dv = flash_attention_backward(
            q, k, v, do.contiguous(), lse, delta.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention over ``[B, H, S, D]`` tensors; with ``return_lse``
    also the per-row logsumexp ``[B, H, S]`` f32. Differentiable in q, k, v
    through both outputs (JAX's ``flash_attention`` and
    ``flash_attention_with_lse``).

    CPU tensors run the plain versions. CUDA tensors launch the kernels or
    raise: they must be contiguous bf16 of one shape with ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`. Without a gradient to track (serving runs
    under ``torch.no_grad()``) the forward is called directly, with no
    autograd bookkeeping."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal)
    else:
        o, lse = _forward(q, k, v, causal)
    return (o, lse) if return_lse else o


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
flash_attention_backward.launches = 0
