"""Port of ``distriflow_tpu/models``: the dense transformer LM and decoding."""
