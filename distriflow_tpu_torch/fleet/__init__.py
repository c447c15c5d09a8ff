"""Port of ``distriflow_tpu/fleet``: the prompt page chain-hash only."""
