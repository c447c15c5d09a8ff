"""Port of ``distriflow_tpu/models/zoo.py``: the LM configurations only.

:func:`flagship_lm_config` is the bench-flagship LM (bench.py's
``transformer_lm_flagship`` row) and :func:`draft_lm_config` the zoo's
small LM; both name their dimensions once so scripts and tests do not
repeat them. The MLP and ConvNet specs wait for their slice.
"""

from __future__ import annotations

import torch

from distriflow_tpu_torch.models.transformer import TransformerConfig


def flagship_lm_config(max_seq: int = 2048, dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """vocab 32000, d_model 512, 8 heads x 64, 8 layers, d_ff 2048."""
    return TransformerConfig(
        vocab_size=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048,
        max_seq=max_seq, dtype=dtype)


def draft_lm_config(max_seq: int = 2048, dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """The small LM: 2 layers at a quarter of the flagship's width (head
    dim 32, which the CUDA kernels are not built for: on the card it runs
    with ``use_flash_attention=False`` and ``use_flash_decode=False``)."""
    return TransformerConfig(
        vocab_size=32000, d_model=128, n_heads=4, n_layers=2, d_ff=512,
        max_seq=max_seq, dtype=dtype)
