"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch version (port of ``distriflow_tpu/ops``).

- :mod:`.flash_attention` — flash attention forward and its two backward
  layouts, fused and two-kernel (replace
  ``distriflow_tpu/ops/flash_attention.py::_fwd_kernel``, ``_dkvq_kernel``,
  ``_dq_kernel`` and ``_dkv_kernel``), differentiable through an
  ``autograd.Function`` that takes the layout JAX would;
- :mod:`.flash_decode` — paged and slab single-token decode attention
  over bf16 and int8 caches (replace
  ``distriflow_tpu/ops/flash_decode.py::_paged_kernel``,
  ``_decode_kernel``, ``_paged_kernel_quant`` and ``_decode_kernel_quant``);
- :mod:`.fused_ce` — the fused softmax cross-entropy, forward and
  backward, on integer labels and on dense targets (replace
  ``distriflow_tpu/ops/fused_ce.py::_fwd_kernel`` and ``_bwd_kernel``,
  ``sparse=True`` and ``sparse=False``);
- :mod:`.depthwise_gn` — MobileNetV2's fused depthwise 3x3 + GroupNorm +
  ReLU6, forward and backward (replace
  ``distriflow_tpu/ops/depthwise_gn.py::_fwd_kernel`` and ``_bwd_kernel``),
  differentiable through an ``autograd.Function``.

Sources live in ``distriflow_tpu_torch/csrc``; :mod:`.build` compiles them
with ``nvcc`` at first use. A wrapper given CPU tensors runs its plain
version; given CUDA tensors it launches its kernel or raises.
"""
