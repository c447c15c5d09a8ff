"""Port of ``distriflow_tpu/models``: the dense transformer LM (serving and
training), decoding, the model abstraction, the loss registry and the LM
zoo configs."""
