"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch version (port of ``distriflow_tpu/ops``).

- :mod:`.flash_attention` — prefill attention (replaces
  ``distriflow_tpu/ops/flash_attention.py::_fwd_kernel``);
- :mod:`.flash_decode` — paged and slab single-token decode attention
  (replace ``distriflow_tpu/ops/flash_decode.py::_paged_kernel`` and
  ``_decode_kernel``).

Sources live in ``distriflow_tpu_torch/csrc``; :mod:`.build` compiles them
with ``nvcc`` at first use. A wrapper given CPU tensors runs its plain
version; given CUDA tensors it launches its kernel or raises.
"""
