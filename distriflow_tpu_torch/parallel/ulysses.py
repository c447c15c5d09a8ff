"""Port of ``distriflow_tpu/parallel/ulysses.py``: Ulysses-style sequence
parallelism, an all-to-all head/sequence swap.

Activations arrive sequence-sharded, this rank's ``[B, H_l, S/n, D]``
(``H_l`` the heads left after the ``model`` axis). One all-to-all over
``seq`` re-shards to head-sharded ``[B, H_l/n, S, D]``: every rank holds
the whole sequence for a subset of heads, so attention runs locally with
exact causal masking (**kernel 1** on CUDA tensors, blockwise attention
on the CPU or with ``use_flash=False``), and a second all-to-all swaps
back. The all-to-all's backward is the inverse all-to-all.

Requires the local head count divisible by the ``seq`` axis size.
"""

from __future__ import annotations

from typing import Optional

import torch

from distriflow_tpu_torch.parallel.collectives import all_to_all
from distriflow_tpu_torch.parallel.mesh import axis_size
from distriflow_tpu_torch.parallel.ring_attention import blockwise_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      axis: str = "seq", causal: bool = True,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """All-to-all sequence-parallel attention of this rank's chunk
    ``[B, H_l, S/n, D]``; returns this rank's output chunk. Every rank of
    the ``axis`` group must call it."""
    n = axis_size(mesh, axis)
    b, local_heads, s, d = q.shape
    h = local_heads * axis_size(mesh, "model")
    if local_heads % n:
        raise ValueError(
            f"local head count {local_heads} (n_heads {h} / model axis) not "
            f"divisible by {axis} axis size {n} — Ulysses shards heads "
            "across the seq group; use ring attention for head counts below "
            "the axis size")
    if use_flash is None:
        use_flash = q.device.type == "cuda"

    def swap_in(t):
        return all_to_all(t, axis, mesh, split_axis=1, concat_axis=2)

    qf, kf, vf = swap_in(q), swap_in(k), swap_in(v)
    if use_flash:
        from distriflow_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(), causal=causal)
    else:
        out = blockwise_attention(qf, kf, vf, causal=causal)
    return all_to_all(out.contiguous(), axis, mesh, split_axis=2, concat_axis=1).to(q.dtype)
