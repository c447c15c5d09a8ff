"""Port of ``distriflow_tpu/models``: the dense transformer LM (serving and
training), decoding, MobileNetV2, the model abstraction with the
``nn.Module`` adapter (``module_model.py``, JAX's ``flax_model.py``) and
``with_uint8_inputs``, the loss registry and the LM zoo configs."""
