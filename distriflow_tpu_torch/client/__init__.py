"""Port of ``distriflow_tpu/client``: the inference client."""
