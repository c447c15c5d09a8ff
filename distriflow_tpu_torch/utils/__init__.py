"""Port of ``distriflow_tpu/utils``: config, logging, serialization, device."""
