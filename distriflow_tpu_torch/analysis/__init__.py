"""Port of ``distriflow_tpu/analysis``: the runtime pool witness only."""
