"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch version (port of ``distriflow_tpu/ops``).

- :mod:`.flash_attention` — flash attention forward and its fused backward
  (replace ``distriflow_tpu/ops/flash_attention.py::_fwd_kernel`` and
  ``_dkvq_kernel``), differentiable through an ``autograd.Function``;
- :mod:`.flash_decode` — paged and slab single-token decode attention
  (replace ``distriflow_tpu/ops/flash_decode.py::_paged_kernel`` and
  ``_decode_kernel``);
- :mod:`.fused_ce` — the fused sparse softmax cross-entropy, forward and
  backward (replace ``distriflow_tpu/ops/fused_ce.py::_fwd_kernel`` and
  ``_bwd_kernel`` with integer labels).

Sources live in ``distriflow_tpu_torch/csrc``; :mod:`.build` compiles them
with ``nvcc`` at first use. A wrapper given CPU tensors runs its plain
version; given CUDA tensors it launches its kernel or raises.
"""
