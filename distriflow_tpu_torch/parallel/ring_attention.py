"""Port of ``distriflow_tpu/parallel/ring_attention.py``: ring attention,
sequence parallelism over the ``seq`` mesh axis.

Each rank holds its Q, K, V chunk ``[B, H, S/n, D]`` (plain local tensors:
JAX's ``shard_map`` body, called by every rank). For ``n`` ring steps a
rank attends its Q chunk to the K/V chunk it holds, then passes K/V one
hop around the ring (:func:`~distriflow_tpu_torch.parallel.collectives.ppermute_ring`,
whose backward carries the K/V gradients back the other way). Causal
masking works on global positions: the chunk held after ``step``
rotations is the one from rank ``(i - step) mod n``.

Two bodies, as in JAX:

- the plain one (``use_flash`` off): the online-softmax recurrence of
  :func:`_attend_block` over the held chunks;
- the flash one: **kernel 1** on each chunk pair through
  ``flash_attention(..., return_lse=True)``. Step 0 (the rank's own
  chunk) is causal; the other steps are non-causal, and chunks from
  later positions get lse ``NEG_INF`` (they run, and merge with weight
  0). The partials merge through their lse in f32 (logaddexp), as JAX
  does. Gradients reach the kernels' backward through the lse
  cotangent, which the attention's autograd folds into delta.

``use_flash=None`` takes the kernel on CUDA tensors and the plain body
on the CPU. The kernel's cost records are made where it runs, once per
executed chunk attention (the port runs eagerly: JAX's trace-multiplicity
correction has nothing to correct here).

Also here: :func:`blockwise_attention` (single-device online softmax over
K/V blocks) and :func:`dense_attention` (plain softmax attention), JAX's
references.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from distriflow_tpu_torch.parallel.collectives import ppermute_ring
from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size

NEG_INF = -1e30


def _attend_block(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    m: torch.Tensor,  # [B, H, Sq]     running max
    l: torch.Tensor,  # [B, H, Sq]     running normalizer
    o: torch.Tensor,  # [B, H, Sq, D]  unnormalized output accumulator
    q_offset: int,
    k_offset: int,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax accumulation step against a K/V block (f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    block_max = s.amax(-1)
    new_m = torch.maximum(m, block_max)
    # guard fully-masked rows: exp(NEG_INF - NEG_INF) must not NaN
    safe_m = torch.where(new_m <= NEG_INF, torch.zeros_like(new_m), new_m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    correction = torch.exp(torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), m - safe_m))
    correction = torch.where(m <= NEG_INF, torch.zeros_like(correction), correction)
    new_l = l * correction + p.sum(-1)
    new_o = o * correction[..., None] + torch.matmul(p, v.float())
    return new_m, new_l, new_o


def _auto_block(s: int, target: int = 512) -> int:
    """Largest divisor of ``s`` that is <= target (so any length works)."""
    for b in range(min(s, target), 0, -1):
        if s % b == 0:
            return b
    return s


def blockwise_attention(q, k, v, causal: bool = True, block_size: Optional[int] = None
                        ) -> torch.Tensor:
    """Single-device online-softmax attention over K/V blocks of
    ``[B, H, S, D]`` tensors: dense softmax attention in O(S·block)
    memory."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    block = block_size or _auto_block(s)
    if s % block:
        raise ValueError(f"sequence {s} not divisible by block {block}")
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for i in range(s // block):
        ks, vs = k[:, :, i * block:(i + 1) * block], v[:, :, i * block:(i + 1) * block]
        m, l, o = _attend_block(q, ks, vs, m, l, o, 0, i * block, causal, scale)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def dense_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain softmax attention over ``[B, H, S, D]`` in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        keep = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(~keep, NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "seq",
                   causal: bool = True, use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention of this rank's sequence chunk ``[B, H, S/n, D]`` over the
    whole sequence held around the ``axis`` ring; returns this rank's
    output chunk. Every rank of the ring must call it."""
    n = axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    chunk = q.shape[2]
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash:
        return _ring_flash(q, k, v, mesh, axis, causal, n, me)
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, s, d = q.shape
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for step in range(n):
        if step:
            k, v = ppermute_ring(k, axis, mesh), ppermute_ring(v, axis, mesh)
        src = (me - step) % n
        m, l, o = _attend_block(q, k, v, m, l, o, me * chunk, src * chunk, causal, scale)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _ring_flash(q, k, v, mesh, axis, causal, n, me) -> torch.Tensor:
    """The flash body: kernel 1 on each chunk pair, lse-merged in f32."""
    from distriflow_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # step 0 holds this rank's own chunk: the causal diagonal
    o_i, lse_acc = flash_attention(q, k, v, causal=causal, return_lse=True)
    o_acc = o_i.float()
    for step in range(1, n):
        k, v = ppermute_ring(k, axis, mesh), ppermute_ring(v, axis, mesh)
        o_i, lse_i = flash_attention(q, k, v, causal=False, return_lse=True)
        if causal and (me - step) % n > me:
            # a chunk from later positions contributes nothing; NEG_INF
            # (not -inf) keeps exp/logaddexp free of inf-inf NaNs
            lse_i = torch.full_like(lse_i, NEG_INF)
        new_lse = torch.logaddexp(lse_acc, lse_i)
        o_acc = (o_acc * torch.exp(lse_acc - new_lse)[..., None]
                 + o_i.float() * torch.exp(lse_i - new_lse)[..., None])
        lse_acc = new_lse
    return o_acc.to(q.dtype)
