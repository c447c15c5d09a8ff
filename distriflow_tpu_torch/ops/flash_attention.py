"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``distriflow_tpu/ops/flash_attention.py``. Four kernels, from two
sources:

- ``csrc/flash_attention.cu`` replaces the Pallas ``_fwd_kernel``: causal
  or non-causal online-softmax attention over ``[B, H, S, D]`` bf16 tensors
  that never writes the ``[S, S]`` scores to device memory, returning O and
  the per-row logsumexp ``[B, H, S]`` f32 (plain, not the TPU kernel's
  128-lane replicated layout);
- ``csrc/flash_attention_bwd.cu`` replaces the fused backward
  ``_dkvq_kernel``: dK, dV and dQ from one P per tile pair. dQ is summed
  over K tiles with f32 atomics, so its summation order is not fixed from
  run to run. The same source replaces the two-kernel backward:
  ``_dq_kernel`` (dQ, one block per Q tile walking its K tiles) and
  ``_dkv_kernel`` (dK and dV, one block per K/V tile walking its Q
  tiles). Neither uses atomics, so both give the same bits every run.

The backward layout is JAX's decision (:func:`bwd_layout`): the backward
tiles JAX would pick (:func:`_bwd_autotune`, or ``bwd_block_q``/
``bwd_block_k`` when pinned) give ``n_kv`` KV blocks; up to
:data:`_FUSED_BWD_MAX_KV_BLOCKS` take the fused kernel, more the two
kernels (bf16 at D 64: S above 8192, long-context training).

:func:`flash_attention` is differentiable: under autograd it goes through
:class:`_FlashAttention`, whose backward computes ``delta = rowsum(dO * O)``
(minus the lse cotangent) in f32 and calls the backward of the chosen
layout. Each wrapper launches its kernel for CUDA tensors and runs its
plain version for CPU tensors. The plain versions keep the kernels'
numeric contracts: scores from bf16 operands accumulated in f32, masked
scores at -1e30 with zero mass, P rounded to the input dtype before each
product it feeds, dS likewise, f32 accumulation, the 1/sqrt(D) scale
applied once after each product.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

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
    "dftt_flash_attention_dq_bf16": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_attention_dkv_bf16": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
}

# The backward layout gate, the port's own copy of the JAX package's
# (flash_attention.py:54-68, 441-498): the tiles its backward would take
# and, from them, how many KV blocks. The CUDA kernels keep their own
# 64-wide tiles; these numbers choose the layout only, so that the port
# takes the fused or the two-kernel backward exactly where JAX does.
_LANES = 128
_BWD_BLOCK_CAP = 1024       # <= 2-byte inputs (bf16/fp16)
_BWD_BLOCK_CAP_WIDE = 256   # 4-byte inputs (f32)
# past this many KV blocks the fused backward's dQ partials (n_kv f32
# copies of Q in JAX) give way to the two-kernel layout
_FUSED_BWD_MAX_KV_BLOCKS = 8
_BWD_VMEM_BUDGET = 8 * 1024 * 1024


def _aligned_block(s: int, target: int) -> int:
    """Largest multiple-of-8 divisor of ``s`` that is ``<= target``, or
    ``s`` itself when it fits in one block or has no such divisor."""
    if s <= target:
        return s
    for blk in range((target // 8) * 8, 0, -8):
        if s % blk == 0:
            return blk
    return s


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _bwd_block_cap(dtype: torch.dtype) -> int:
    """JAX's largest backward tile for the input dtype (``_block_caps``)."""
    return _BWD_BLOCK_CAP if _itemsize(dtype) <= 2 else _BWD_BLOCK_CAP_WIDE


def _bwd_vmem_estimate(bq: int, bk: int, d: int, itemsize: int) -> int:
    """JAX's analytic per-grid-step working set of its fused backward."""
    est = 2 * bq * d * itemsize + 2 * bk * d * itemsize  # q/do + k/v blocks
    est += 2 * bq * _LANES * 4                           # lse + delta
    est += 2 * bk * d * 4                                # dk/dv accumulators
    est += bq * d * 4                                    # dq-partial out block
    est += bq * bk * 4                                   # f32 score tile
    return est


def _bwd_autotune(s: int, d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """JAX's backward tile pick: the largest aligned divisor of ``s`` under
    the dtype's cap whose working set passes the estimate."""
    itemsize = _itemsize(dtype)
    target = _bwd_block_cap(dtype)
    while target > 8:
        bq = _aligned_block(s, target)
        bk = _aligned_block(s, target)
        if _bwd_vmem_estimate(bq, bk, d, itemsize) <= _BWD_VMEM_BUDGET:
            return bq, bk
        target //= 2
    return _aligned_block(s, 8), _aligned_block(s, 8)


def bwd_layout(s: int, d: int, dtype: torch.dtype, bwd_block_k: Optional[int] = None) -> str:
    """``"fused"`` or ``"split"``: the backward JAX's ``_flash_backward``
    takes at sequence length ``s``, head dim ``d`` and input ``dtype``,
    with its KV tile autotuned or pinned by ``bwd_block_k`` (the Q tile
    does not enter the decision)."""
    _, bk = _bwd_autotune(s, d, dtype)
    if bwd_block_k is not None:
        bk = _aligned_block(s, min(bwd_block_k, _bwd_block_cap(dtype)))
    return "fused" if s // bk <= _FUSED_BWD_MAX_KV_BLOCKS else "split"


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
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dq = torch.matmul(ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's recomputed P = ``exp(s * scale - lse)`` (f32, masked
    pairs exactly 0) and dS = ``P (dP - delta)`` rounded to the input dtype
    (held in f32), both ``[..., S, S]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
    p = torch.exp(s - lse.float()[..., None])  # masked: exp(-1e30 - lse) == 0
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    return p, ds


def _per_head(fn, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn`` on each (b, h) slice of ``[B, H, ...]`` tensors in turn, its
    outputs stacked back: one ``[S, S]`` f32 score tensor is live at a time
    (1.07 GB at S 16384, where all heads at once would not fit)."""
    b, h = tensors[0].shape[:2]
    outs = [fn(*(t[i, j:j + 1][None] for t in tensors))
            for i in range(b) for j in range(h)]
    return tuple(torch.cat([o[n] for o in outs], 0).reshape(b, h, *outs[0][n].shape[2:])
                 for n in range(len(outs[0])))


def flash_attention_dq_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> torch.Tensor:
    """Plain version of the dQ kernel (JAX ``_dq_kernel``,
    ``flash_attention.py:171-209``): ``dQ = scale * dS K`` in q's dtype,
    dS as in :func:`flash_attention_backward_reference`. One (b, h) slice
    at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v, do, lse, delta):
        _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
        return ((torch.matmul(ds, k.float()) * scale).to(q.dtype),)

    return _per_head(one, q, k, v, do, lse, delta)[0]


def flash_attention_dkv_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel (JAX ``_dkv_kernel``,
    ``flash_attention.py:223-269``): ``dK = scale * dS^T Q`` and ``dV =
    P^T dO`` with P rounded to the input dtype, in k's and v's dtypes. One
    (b, h) slice at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def one(q, k, v, do, lse, delta):
        p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
        dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
        return dk.to(k.dtype), dv.to(v.dtype)

    return _per_head(one, q, k, v, do, lse, delta)


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
    _check_backward_inputs("flash_attention_backward", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
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


def _check_backward_inputs(what: str, q, k, v, do, lse, delta) -> None:
    _check_kernel_inputs(what, q, q=q, k=k, v=v, do=do)
    b, h, s, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous f32 [{b}, {h}, {s}] on {q.device}")


def flash_attention_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> torch.Tensor:
    """dQ of attention, the first half of the two-kernel backward, from
    the forward's ``lse`` and ``delta`` (both ``[B, H, S]`` f32).

    CPU tensors run :func:`flash_attention_dq_reference`. CUDA tensors
    launch the dQ kernel or raise, on the inputs
    :func:`flash_attention_backward` takes. The kernel writes the scaled
    bf16 dQ once per Q tile, with no atomics."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    _check_backward_inputs("flash_attention_dq", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    rc = lib.dftt_flash_attention_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of attention, the second half of the two-kernel
    backward. CPU tensors run :func:`flash_attention_dkv_reference`; CUDA
    tensors launch the dK/dV kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal)
    _check_backward_inputs("flash_attention_dkv", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    rc = lib.dftt_flash_attention_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, d, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Autograd around the kernels (JAX: ``jax.custom_vjp``). The forward
    saves ``(q, k, v, o, lse)``; the backward folds the lse cotangent into
    delta (``dlse/ds = p``, ``flash_attention.py:553-560``) and takes the
    layout :func:`bwd_layout` names."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd_block_k):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.bwd_block_k = bwd_block_k
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
        args = (q, k, v, do.contiguous(), lse, delta.contiguous(), ctx.causal)
        _, _, s, d = q.shape
        if bwd_layout(s, d, q.dtype, ctx.bwd_block_k) == "fused":
            dq, dk, dv = flash_attention_backward(*args)
        else:
            dq = flash_attention_dq(*args)
            dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    return_lse: bool = False, bwd_block_q: Optional[int] = None,
    bwd_block_k: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention over ``[B, H, S, D]`` tensors; with ``return_lse``
    also the per-row logsumexp ``[B, H, S]`` f32. Differentiable in q, k, v
    through both outputs (JAX's ``flash_attention`` and
    ``flash_attention_with_lse``).

    ``bwd_block_q``/``bwd_block_k`` are JAX's backward tiles (``None``:
    autotuned, as there). Here they choose the backward's layout only
    (:func:`bwd_layout`: the fused kernel up to 8 KV blocks, the dQ and
    dK/dV kernels past that); the CUDA kernels keep their own 64-wide
    tiles, and the Q tile changes nothing.

    CPU tensors run the plain versions. CUDA tensors launch the kernels or
    raise: they must be contiguous bf16 of one shape with ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`. Without a gradient to track (serving runs
    under ``torch.no_grad()``) the forward is called directly, with no
    autograd bookkeeping."""
    del bwd_block_q  # JAX's Q tile; the layout depends on the KV tile alone
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal, bwd_block_k)
    else:
        o, lse = _forward(q, k, v, causal)
    return (o, lse) if return_lse else o


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
flash_attention_backward.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
