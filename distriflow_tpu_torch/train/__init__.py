"""Port of ``distriflow_tpu/train``: the single-device synchronous trainer."""
