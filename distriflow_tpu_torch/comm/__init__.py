"""Port of ``distriflow_tpu/comm``: frame codec, socket transport, and the
wire-schema registry (``comm/schema.py``: ``MESSAGES``, ``PAYLOADS``,
``check_payload``), each imported as its submodule."""
