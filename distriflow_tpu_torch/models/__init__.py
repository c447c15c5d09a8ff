"""Port of ``distriflow_tpu/models``: the dense transformer LM (serving and
training), decoding, MobileNetV2, the model abstraction with the
``nn.Module`` adapter (``module_model.py``, JAX's ``flax_model.py``) and
``with_uint8_inputs``, the loss registry, the LM zoo configs, the Keras
importer and the dynamic model.

The model sources of JAX's ``distriflow_tpu.models`` are exported under
JAX's names, each imported when first read (this package imports nothing
eagerly)."""

import importlib

_EXPORTS = {
    "DistributedDynamicModel": "dynamic",
    "fetch_model": "base",
    "spec_from_keras_json": "keras_import",
    "spec_from_keras_h5": "keras_import",
    "spec_from_url": "keras_import",
    "export_keras_weights": "keras_import",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
