"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of ``distriflow_tpu/ops/flash_attention.py``. Four bf16 kernels
from two sources, and four f32 kernels from a third:

- ``csrc/flash_attention.cu`` replaces the Pallas ``_fwd_kernel``: causal
  or non-causal online-softmax attention over ``[B, H, S, D]`` bf16 tensors
  that never writes the ``[S, S]`` scores to device memory, returning O and
  the per-row logsumexp ``[B, H, S]`` f32 (plain, not the TPU kernel's
  128-lane replicated layout); a Hopper design (TMA loads, wgmma, the
  softmax in registers), at head dim 32 one of its own (``d32::fwd_kernel``,
  which the exponentials bound), taken by the C entry at every D 32 shape;
- ``csrc/flash_attention_bwd.cu`` replaces the fused backward
  ``_dkvq_kernel``: dK, dV and dQ from one P per tile pair. As in JAX,
  each live (KV tile, Q tile) pair writes its f32 dQ partial once and a
  second pass sums them (the live range is ``live_kv_tiles`` in the
  source). The same source replaces the two-kernel backward: ``_dq_kernel`` (dQ, one
  block per Q tile walking its K tiles) and ``_dkv_kernel`` (dK and dV,
  one block per K/V tile walking its Q tiles). All are Hopper designs
  like the forward's; none uses atomics, so each gives the same bits
  every run;
- ``csrc/flash_attention_f32.cu`` replaces ``_fwd_kernel``,
  ``_dkvq_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` on f32 inputs (the
  JAX LM CLI's ``--dtype float32``, and with ``--seq 16384`` the
  two-kernel layout that JAX takes for f32 past 2048 positions), all on
  the tensor cores in split-precision TF32 (each f32 operand split into
  two TF32 parts and each product taken as three TF32 products summed in
  f32, which keeps f32's accuracy where one TF32 pass does not); the
  fused backward writes its f32 dQ partials once per 64-key block, summed
  by a second kernel. Their arithmetic has plain mirrors,
  :func:`flash_attention_forward_split_tf32_reference`,
  :func:`flash_attention_fused_split_tf32_reference` and
  :func:`flash_attention_split_tf32_reference`, for the tests and
  ``chip_smoke.py``.

Every kernel is built for head dims 64 and 32 (:data:`SUPPORTED_HEAD_DIMS`,
:data:`BWD_HEAD_DIMS`); a wrapper counts its launches in ``launches``, by
head dim in ``launches_by_head_dim`` and by dtype in ``launches_by_dtype``.

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

from distriflow_tpu_torch.ops import build, flop_count

NEG_INF = -1e30
#: the head dims the forward kernel is built and checked for: the
#: flagship's 64, and 32 (the speculative draft's and the JAX LM CLI's)
SUPPORTED_HEAD_DIMS = (32, 64)
#: the head dims the backward kernels are built for
BWD_HEAD_DIMS = (32, 64)
#: the input dtypes the kernels take, in every layout: bf16 and f32
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_SIGNATURES = {
    "dftt_flash_attention_fwd_bf16": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}
_F32_SIGNATURES = {
    "dftt_flash_attention_fwd_f32": _SIGNATURES["dftt_flash_attention_fwd_bf16"],
    "dftt_flash_attention_bwd_f32": [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_attention_dq_f32": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
    "dftt_flash_attention_dkv_f32": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "dftt_flash_attention_bwd_bf16": [ctypes.c_void_p] * 10 + [
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
# tiles; these numbers choose the layout only, so that the port
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


def _bwd_kv_blocks(s: int, d: int, dtype: torch.dtype, bwd_block_k: Optional[int] = None) -> int:
    """The number of KV blocks of JAX's backward tiles at sequence length
    ``s``, head dim ``d`` and input ``dtype``, with its KV tile autotuned
    or pinned by ``bwd_block_k``."""
    _, bk = _bwd_autotune(s, d, dtype)
    if bwd_block_k is not None:
        bk = _aligned_block(s, min(bwd_block_k, _bwd_block_cap(dtype)))
    return s // bk


def bwd_layout(s: int, d: int, dtype: torch.dtype, bwd_block_k: Optional[int] = None) -> str:
    """``"fused"`` or ``"split"``: the backward JAX's ``_flash_backward``
    takes at sequence length ``s``, head dim ``d`` and input ``dtype``,
    with its KV tile autotuned or pinned by ``bwd_block_k`` (the Q tile
    does not enter the decision)."""
    fused = _bwd_kv_blocks(s, d, dtype, bwd_block_k) <= _FUSED_BWD_MAX_KV_BLOCKS
    return "fused" if fused else "split"


def _record_forward_cost(q: torch.Tensor, causal: bool) -> None:
    """JAX's analytic cost of one forward (``_flash_forward``): QK^T + PV,
    each 2*B*H*S*S*D, halved by the causal tile skip. In f32 the kernel
    runs both products as split-precision TF32 (``tf32x3``)."""
    b, h, s, d = q.shape
    div = 2 if causal else 1
    flops = 4 * b * h * s * s * d // div
    f32 = q.dtype == torch.float32
    flop_count.record_kernel_cost(
        flops=flops, bytes_accessed=4 * b * h * s * d * q.element_size(),
        transcendentals=b * h * s * s // div, category="attention_fwd",
        f32=f32, tf32x3=flops if f32 else 0)


def _record_backward_cost(q: torch.Tensor, causal: bool, bwd_block_k: Optional[int]) -> None:
    """JAX's analytic cost of one backward (``_flash_backward``), in the
    layout it takes: four matmuls of model FLOPs; the fused layout runs 5
    and reads its f32 dQ partials, the two-kernel layout runs 7. In f32
    the fused layout runs all 5 as split-precision TF32, the two-kernel
    layout :data:`_F32_SPLIT_TF32_PRODUCTS` of its 7 (the rest, S and dP
    of the dQ kernel, on FFMA)."""
    b, h, s, d = q.shape
    n_kv = _bwd_kv_blocks(s, d, q.dtype, bwd_block_k)
    fused = n_kv <= _FUSED_BWD_MAX_KV_BLOCKS
    div = 2 if causal else 1
    unit = 2 * b * h * s * s * d // div
    f32 = q.dtype == torch.float32
    flop_count.record_kernel_cost(
        flops=4 * unit,
        bytes_accessed=8 * b * h * s * d * q.element_size()
        + (2 * n_kv * b * h * s * d * 4 if fused else 0),
        transcendentals=(1 if fused else 2) * b * h * s * s // div,
        category="attention_bwd", hw_flops=(5 if fused else 7) * unit, f32=f32,
        tf32x3=(5 if fused else _F32_SPLIT_TF32_PRODUCTS) * unit if f32 else 0)


# The products of the f32 two-kernel backward that run as split-precision
# TF32 on the tensor cores (csrc/flash_attention_f32.cu): dS.K in the dQ
# kernel and all four of the dK/dV kernel's; the dQ kernel's S and dP stay
# FFMA sums. The f32 fused backward runs all five of its products so.
_F32_SPLIT_TF32_PRODUCTS = 5


# The fused backward kernels' KV tiles (``kBKV`` in
# csrc/flash_attention_bwd.cu) and, in f32, the key block of
# ``split3::bwd_kernel`` by head dim (16 x ``FusedShape<D>::kWarps`` in
# csrc/flash_attention_f32.cu): the dQ scratch holds one slab per KV tile
_FUSED_BWD_BLOCK_KV = 128
_F32_BWD_BLOCK_KV = {32: 64, 64: 64}


def _dq_slabs(s: int, d: int, dtype: torch.dtype) -> int:
    """The fused backward's dQ partial slabs at sequence length ``s``, head
    dim ``d`` and input ``dtype``: one per KV tile of its kernel."""
    return -(-s // (_F32_BWD_BLOCK_KV[d] if dtype == torch.float32 else _FUSED_BWD_BLOCK_KV))


def flash_seq_supported(s: int, d: int, itemsize: int = 2) -> bool:
    """True when the kernel takes a prompt of length ``s`` at head dim
    ``d`` and element size ``itemsize``: bf16 (2) or f32 (4), and ``d``
    in :data:`SUPPORTED_HEAD_DIMS`. Any ``s >= 1`` tiles (edges are
    masked) and the shared-memory footprint does not grow with ``s``."""
    return s >= 1 and itemsize in (2, 4) and d in SUPPORTED_HEAD_DIMS


def backward_supported(d: int, dtype: torch.dtype) -> bool:
    """True when a kernel takes the attention backward at head dim ``d``
    and input ``dtype``: bf16 or f32 in either layout (:func:`bwd_layout`
    chooses which), ``d`` in :data:`BWD_HEAD_DIMS`."""
    return d in BWD_HEAD_DIMS and dtype in KERNEL_DTYPES


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


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to 10
    mantissa bits, to nearest with ties away from zero, on the f32 bits
    (the 13 low bits cleared). A NaN or an infinity (every exponent bit
    set) is left as it is: the rounding's carry would turn a NaN into a
    zero or an infinity. The value stays an f32 tensor."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    rounded = (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)
    return torch.where((bits & 0x7F800000) == 0x7F800000, x, rounded)


def _split_tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the split-precision kernels take it: each operand split
    into ``big = tf32(x)`` and ``small = tf32(x - big)`` (``x - big`` is
    exact in f32) and the three TF32 products summed in f32, the small
    cross terms first. ``passes=1``: one TF32 product, ``tf32(a) @
    tf32(b)``; ``passes=0``: the product as it is, in the operands' dtype.
    TF32 values multiply exactly in f32, so the f32 matmul of the parts is
    the tensor cores' product of them."""
    if passes == 0:
        return a @ b
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return ab @ bb
    a_small, b_small = _tf32_rna(a - ab), _tf32_rna(b - bb)
    return (a_small @ bb + ab @ b_small) + ab @ bb


def flash_attention_split_tf32_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True, passes: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain mirror of the f32 two-kernel backward's arithmetic
    (``dq_kernel`` and ``dkv_kernel`` in ``csrc/flash_attention_f32.cu``):
    ``(dQ, dK, dV)`` f32 from f32 ``[B, H, S, D]`` inputs. The products the
    kernels run in split-precision TF32 are taken by
    :func:`_split_tf32_matmul` (``passes`` 3, or 1 for one TF32 pass): the
    dK/dV kernel's four, S = Q K^T, dP = dO V^T, P^T dO and dS^T Q, and the
    dQ kernel's dS K, whose S and dP are f32 sums as in the plain version.
    Everything else is f32 as in :func:`flash_attention_dq_reference`: the
    scale after the sum, masked pairs exactly 0, dS = P (dP - delta). The
    kernels' own sum order (8-wide k-steps, each added to an f32 sum) is
    not mirrored. For the tests and ``chip_smoke.py`` only; one (b, h)
    slice at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def mm(a, b):
        return _split_tf32_matmul(a, b, passes)

    def one(q, k, v, do, lse, delta):
        q, k, v, do = (t.float() for t in (q, k, v, do))
        keep = _causal_keep(q.shape[2], q.device) if causal else None

        def dscores(s, dp):
            p = torch.exp(s * scale - lse.float()[..., None])
            if keep is not None:
                p = torch.where(keep, p, torch.zeros_like(p))
            return p, p * (dp - delta.float()[..., None])

        _, ds = dscores(q @ k.transpose(-1, -2), do @ v.transpose(-1, -2))
        dq = mm(ds, k) * scale
        p, ds = dscores(mm(q, k.transpose(-1, -2)), mm(do, v.transpose(-1, -2)))
        return dq, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), do)

    return _per_head(one, q, k, v, do, lse, delta)


def flash_attention_fused_split_tf32_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True, passes: int = 3,
    split_scores: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain mirror of the f32 fused backward's arithmetic (``bwd_kernel``
    and ``dq_sum_kernel`` of namespace ``split3`` in
    ``csrc/flash_attention_f32.cu``): ``(dQ, dK, dV)`` f32 from f32 ``[B,
    H, S, D]`` inputs. All five products, S = Q K^T, dP = dO V^T, P^T dO,
    dS^T Q and dS K, are taken by :func:`_split_tf32_matmul` (``passes`` 3,
    or 1 for one TF32 pass; ``split_scores=False`` leaves S and dP f32
    products). dQ is summed as the kernel sums it: one partial dS K over
    each block of the kernel's key block (:data:`_F32_BWD_BLOCK_KV`), the
    partials added in ascending block, the scale after the sum. Everything
    else is f32 as in :func:`flash_attention_backward_reference`: the scale
    after the sum, masked pairs exactly 0, dS = P (dP - delta). The
    kernel's sum order inside a product (8-wide k-steps) is not mirrored.
    For the tests, ``chip_smoke.py`` and ``tools/f32_fused_bwd_probe.py``;
    one (b, h) slice at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    blk = _F32_BWD_BLOCK_KV[q.shape[-1]]

    def mm(a, b, scores=False):
        return _split_tf32_matmul(a, b, passes if split_scores or not scores else 0)

    def one(q, k, v, do, lse, delta):
        q, k, v, do = (t.float() for t in (q, k, v, do))
        p = torch.exp(mm(q, k.transpose(-1, -2), True) * scale - lse.float()[..., None])
        if causal:
            p = torch.where(_causal_keep(q.shape[2], q.device), p, torch.zeros_like(p))
        ds = p * (mm(do, v.transpose(-1, -2), True) - delta.float()[..., None])
        dq = None
        for j in range(0, q.shape[2], blk):
            part = mm(ds[..., j:j + blk], k[..., j:j + blk, :])
            dq = part if dq is None else dq + part
        return dq * scale, mm(ds.transpose(-1, -2), q) * scale, mm(p.transpose(-1, -2), do)

    return _per_head(one, q, k, v, do, lse, delta)


def flash_attention_forward_split_tf32_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    passes: Union[int, Tuple[int, int]] = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of the f32 forward kernel's arithmetic (``fwd_kernel``
    in ``csrc/flash_attention_f32.cu``): ``(O [B,H,S,D], lse [B,H,S])``
    from f32 inputs, in their dtype. Both products, S = Q K^T and P V, are
    taken by :func:`_split_tf32_matmul` (``passes`` 3, or 1 for one TF32
    pass; a pair gives S's and P V's apart, 0 the product unsplit, so
    ``passes=0`` on f64 inputs is the recipe in f64); everything else is
    as in :func:`flash_attention_reference`: the scale after the sum,
    masked scores at -1e30 with exactly zero mass, O = P V / max(l,
    1e-30), lse = m + log(l). The kernel's online softmax (P against the
    running max of each 64-key tile, rescaled) and its sum order are not
    mirrored. For the tests, ``chip_smoke.py`` and
    ``tools/f32_fwd_limit_probe.py`` only; one (b, h) slice at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_passes, pv_passes = (passes, passes) if isinstance(passes, int) else passes

    def one(q, k, v):
        s = _split_tf32_matmul(q, k.transpose(-1, -2), s_passes) * scale
        if causal:
            s = s.masked_fill(~_causal_keep(q.shape[2], q.device), NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        safe_m = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
        p = torch.where(s <= NEG_INF, torch.zeros_like(s), torch.exp(s - safe_m))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        return _split_tf32_matmul(p, v, pv_passes) / l, (safe_m + torch.log(l)).squeeze(-1)

    return _per_head(one, q, k, v)


def _check_kernel_inputs(what: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous [B, H, S, D] tensor of
    ref's dtype (bf16 or f32) shaped like ``ref`` on ref's CUDA device, at
    a (S, D) the kernels take."""
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    for name, t in tensors.items():
        if t.device != ref.device or t.shape != ref.shape or t.dim() != 4:
            raise ValueError(
                f"{what}: {name} must be [B, H, S, D] like q "
                f"{tuple(ref.shape)} on {ref.device}, got {tuple(t.shape)} on {t.device}")
        if t.dtype not in KERNEL_DTYPES or t.dtype != ref.dtype:
            names = " or ".join(str(x).replace("torch.", "") for x in KERNEL_DTYPES)
            raise TypeError(f"{what}: the kernel takes {names} (all of one dtype), "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    _, _, s, d = ref.shape
    if not flash_seq_supported(s, d, ref.element_size()):
        raise ValueError(f"{what}: no kernel for S={s}, D={d}")
    if what != "flash_attention" and d not in BWD_HEAD_DIMS:
        raise ValueError(f"{what}: the backward kernels take D in {BWD_HEAD_DIMS}, got D={d}")


def _forward(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse: the kernel on CUDA tensors, the plain version on CPU;
    either records the forward's analytic cost."""
    _record_forward_cost(q, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_kernel_inputs("flash_attention", q, q=q, k=k, v=v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        # the kernel copies rows in 16-byte pieces: an input that starts
        # off that boundary (a view at an odd offset) goes as an aligned copy
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
        fn = build.load("flash_attention_f32", _F32_SIGNATURES).dftt_flash_attention_fwd_f32
    else:
        fn = build.load("flash_attention", _SIGNATURES).dftt_flash_attention_fwd_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * h, s, d, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    build.count_launch(flash_attention, d, q.dtype)
    return o, lse


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dQ, dK, dV)`` of attention from the forward's ``lse`` and ``delta
    = rowsum(dO * O)`` (minus any lse cotangent), both ``[B, H, S]`` f32.

    CPU tensors run :func:`flash_attention_backward_reference`. CUDA
    tensors launch the backward kernel or raise: q/k/v/dO contiguous bf16
    or f32 of one shape with ``D`` in :data:`BWD_HEAD_DIMS`, lse/delta
    contiguous f32. The kernel writes each live pair's f32 dQ partial once
    into a ``[n_kv, B*H, S, D]`` scratch (JAX's layout at the kernel's KV
    tile, :func:`_dq_slabs`, never zeroed), and a second kernel sums them
    in ascending KV tile, scales and casts: two kernels, one launch
    counted. In f32 the first kernel runs its five products in
    split-precision TF32 (mirrored by
    :func:`flash_attention_fused_split_tf32_reference`)."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do, lse, delta, causal)
    _check_backward_inputs("flash_attention_backward", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dqp = torch.empty((_dq_slabs(s, d, q.dtype), b * h, s, d), dtype=torch.float32,
                      device=q.device)
    if q.dtype == torch.float32:
        fn = build.load("flash_attention_f32", _F32_SIGNATURES).dftt_flash_attention_bwd_f32
    else:
        fn = build.load("flash_attention_bwd", _BWD_SIGNATURES).dftt_flash_attention_bwd_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqp.data_ptr(), dq.data_ptr(),
            b * h, s, d, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_backward")
    build.count_launch(flash_attention_backward, d, q.dtype)
    return dq, dk, dv


def _check_backward_inputs(what: str, q, k, v, do, lse, delta) -> None:
    _check_kernel_inputs(what, q, q=q, k=k, v=v, do=do)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary (the kernels "
                             f"copy rows in 16-byte pieces)")
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
    launch the dQ kernel of q's dtype or raise, on the inputs
    :func:`flash_attention_backward` takes. The kernel writes the scaled
    dQ once per Q tile, with no atomics."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal)
    _check_backward_inputs("flash_attention_dq", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    if q.dtype == torch.float32:
        fn = build.load("flash_attention_f32", _F32_SIGNATURES).dftt_flash_attention_dq_f32
    else:
        fn = build.load("flash_attention_bwd", _BWD_SIGNATURES).dftt_flash_attention_dq_bf16
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_dq")
    build.count_launch(flash_attention_dq, d, q.dtype)
    return dq


def flash_attention_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of attention, the second half of the two-kernel
    backward. CPU tensors run :func:`flash_attention_dkv_reference`; CUDA
    tensors launch the dK/dV kernel of q's dtype or raise."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal)
    _check_backward_inputs("flash_attention_dkv", q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        fn = build.load("flash_attention_f32", _F32_SIGNATURES).dftt_flash_attention_dkv_f32
    else:
        fn = build.load("flash_attention_bwd", _BWD_SIGNATURES).dftt_flash_attention_dkv_bf16
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, d, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_dkv")
    build.count_launch(flash_attention_dkv, d, q.dtype)
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
        _record_backward_cost(q, ctx.causal, ctx.bwd_block_k)
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
    dK/dV kernels past that); the CUDA kernels keep their own tiles, and
    the Q tile changes nothing.

    CPU tensors run the plain versions. CUDA tensors launch the kernels or
    raise: they must be contiguous bf16 or f32 of one shape with ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`. Without a gradient to track (serving runs
    under ``torch.no_grad()``) the forward is called directly, with no
    autograd bookkeeping."""
    del bwd_block_q  # JAX's Q tile; the layout depends on the KV tile alone
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, causal, bwd_block_k)
    else:
        o, lse = _forward(q, k, v, causal)
    return (o, lse) if return_lse else o


#: kernel launches since the count was last set to 0, also by head dim and
#: by dtype
for _fn in (flash_attention, flash_attention_backward, flash_attention_dq, flash_attention_dkv):
    _fn.launches = 0
    _fn.launches_by_head_dim = {}
    _fn.launches_by_dtype = {}
del _fn
