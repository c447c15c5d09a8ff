"""Port of ``distriflow_tpu/comm``: frame codec and socket transport."""
