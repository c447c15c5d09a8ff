"""Port of ``distriflow_tpu/train``: the single-device synchronous trainer
and the chunked training loop with exact chunked evaluation."""
