"""PyTorch/CUDA port of ``distriflow_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``train/``, ``data/``, ``server/``, ``client/``,
``comm/``, ``obs/``, ``fleet/``, ``parallel/``, ``utils/``, ``doctor.py``) so each
module's counterpart is easy to find. It imports
``torch`` and numpy and never ``jax`` or anything under ``distriflow_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit CPU request they raise.

Import submodules directly (``from distriflow_tpu_torch.server import
InferenceServer``): this package module imports nothing eagerly.
"""
