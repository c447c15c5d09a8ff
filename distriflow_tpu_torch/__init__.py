"""PyTorch/CUDA port of ``distriflow_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``train/``, ``data/``, ``server/``, ``client/``,
``comm/``, ``obs/``, ``fleet/``, ``parallel/``, ``utils/``, ``analysis/``,
``doctor.py``) so each
module's counterpart is easy to find. It imports
``torch`` and numpy and never ``jax`` or anything under ``distriflow_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit CPU request they raise.

Import submodules directly (``from distriflow_tpu_torch.server import
InferenceServer``): this package module imports nothing eagerly. The
model and data sources are also exported here under JAX's names, each
imported when first read.
"""

import importlib

# the data names exported here; the model names are models' own table
_DATA_EXPORTS = ("StreamingTokenDataset", "write_token_file")


def __getattr__(name):
    if name in _DATA_EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.data"), name)
    models = importlib.import_module(f"{__name__}.models")
    if name in models.__all__:
        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
