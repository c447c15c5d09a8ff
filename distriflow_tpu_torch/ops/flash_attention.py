"""Prefill attention: a hand-written Hopper kernel and its plain version.

Port of ``distriflow_tpu/ops/flash_attention.py`` (forward only; the
backward kernels wait for the training slice). The kernel,
``csrc/flash_attention.cu``, replaces the Pallas ``_fwd_kernel``: causal or
non-causal online-softmax attention over ``[B, H, S, D]`` bf16 tensors
that never writes the ``[S, S]`` scores to device memory, returning O and
the per-row logsumexp ``[B, H, S]`` f32 (plain, not the TPU kernel's
128-lane replicated layout).

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_reference` for CPU tensors. The reference keeps the
kernel's numeric contract: scores from bf16 operands accumulated in f32,
masked scores at -1e30 with zero mass, p rounded to the value dtype for
the PV product, f32 accumulation.
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


def flash_seq_supported(s: int, d: int, itemsize: int = 2) -> bool:
    """True when the kernel takes a prompt of length ``s`` at head dim
    ``d`` and element size ``itemsize``: bf16 and ``d`` in
    :data:`SUPPORTED_HEAD_DIMS`. Any ``s >= 1`` tiles (edges are masked)
    and the shared-memory footprint does not grow with ``s``."""
    return s >= 1 and itemsize == 2 and d in SUPPORTED_HEAD_DIMS


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(O [B,H,S,D] in q's dtype,
    lse [B,H,S] f32)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n = q.shape[2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (safe_m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention over ``[B, H, S, D]`` tensors; with ``return_lse``
    also the per-row logsumexp ``[B, H, S]`` f32.

    CPU tensors run the plain version. CUDA tensors launch the kernel or
    raise: they must be contiguous bf16 of one shape with ``D`` in
    :data:`SUPPORTED_HEAD_DIMS`."""
    if q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, causal)
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.shape != q.shape or t.dim() != 4:
            raise ValueError(
                f"flash_attention: {name} must be [B, H, S, D] like q "
                f"{tuple(q.shape)} on {q.device}, got {tuple(t.shape)} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: the kernel takes bf16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, h, s, d = q.shape
    if not flash_seq_supported(s, d):
        raise ValueError(f"flash_attention: no kernel for S={s}, D={d}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention", _SIGNATURES)
    rc = lib.dftt_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, s, d, int(causal), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
