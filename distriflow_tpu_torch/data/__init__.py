"""Port of ``distriflow_tpu/data``: the host batch stream and device
prefetch of the training loops."""
