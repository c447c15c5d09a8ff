"""Port of ``distriflow_tpu/server``: the inference server."""
