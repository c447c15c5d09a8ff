"""Port parity: the wire-schema registry (``distriflow_tpu_torch/comm/
schema.py``) against JAX's, and the port's live payloads against it.

- ``MESSAGES``/``PAYLOADS`` equal JAX's field by field (names, ``since``,
  ``required``, wire and attr flags, nested schemas, versions);
- the format versions equal the port's runtime encoders' constants;
- the port's ``ReportBuilder`` reports, its ``flat_serialize`` leaves (dense,
  int8, top-k) and the requests and acks of its loopback inference server
  (one generate, one beam, one score on the CPU) pass ``check_payload``,
  through the tap ``chip_smoke.py`` holds the card's payloads with;
- the registry is clean under the wire family's own lints and agrees with
  docs/ANALYSIS.md's wire tables.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu.comm import schema as jax_schema
from distriflow_tpu_torch.comm import schema
from distriflow_tpu_torch.comm.schema import PAYLOADS, check_payload

pytestmark = [pytest.mark.port, pytest.mark.analysis]

MESSAGE_NAMES = ["ModelMsg", "GradientMsg", "DataMsg", "UploadMsg", "DownloadMsg"]
PAYLOAD_NAMES = ["report", "fleet_stats", "ring_membership", "hedge_cancel",
                 "hedge_cancel_ack", "generate_request", "generate_ack", "serving_meta",
                 "beam_request", "score_request", "direct_ack", "hyperparam_override",
                 "controller_action", "dftp_leaf"]


def test_registry_names_equal_jax():
    assert list(schema.MESSAGES) == list(jax_schema.MESSAGES) == MESSAGE_NAMES
    assert list(schema.PAYLOADS) == list(jax_schema.PAYLOADS) == PAYLOAD_NAMES
    assert schema.__all__ == jax_schema.__all__


@pytest.mark.parametrize("name", MESSAGE_NAMES + PAYLOAD_NAMES)
def test_format_equals_jax_field_by_field(name):
    table = "MESSAGES" if name in MESSAGE_NAMES else "PAYLOADS"
    port, ref = getattr(schema, table)[name], getattr(jax_schema, table)[name]
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.required_names == ref.required_names
    assert port.names == ref.names


def test_report_version_matches_the_port_collector():
    from distriflow_tpu_torch.obs.collector import REPORT_VERSION

    assert PAYLOADS["report"].version == REPORT_VERSION


def test_dftp_leaf_version_matches_the_port_serializer():
    from distriflow_tpu_torch.utils import serialization

    leaf = PAYLOADS["dftp_leaf"]
    assert leaf.version == serialization._VERSION_SPARSE
    assert serialization._VERSION == 1
    assert {f.name for f in leaf.fields if f.since == 2} == {
        "encoding", "index_dtype", "indices_offset", "indices_nbytes"}


def test_report_builder_output_satisfies_schema():
    from distriflow_tpu_torch.obs import Telemetry
    from distriflow_tpu_torch.obs.collector import ReportBuilder

    tel = Telemetry()
    tel.counter("client_uploads_total", help="uploads").inc()
    tel.histogram("phase_ms", phase="fit", role="client", help="phase ms").observe(2.0)
    rb = ReportBuilder(tel, "c1")
    check_payload("report", rb.build())  # full
    tel.counter("client_uploads_total").inc()
    check_payload("report", rb.build())  # delta


@pytest.mark.parametrize("encoding", ["dense", "int8", "topk", "topk_int8"])
def test_flat_serialize_leaves_satisfy_schema(encoding):
    from distriflow_tpu_torch.utils import serialization as ser

    rng = np.random.default_rng(3)
    tree = {"w": torch.tensor(rng.normal(size=(4, 6)), dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=(6,)), dtype=torch.float32)}
    encode = {"dense": ser.serialize_array, "int8": ser.quantize_array,
              "topk": lambda t: ser.topk_array(t, 0.25),
              "topk_int8": lambda t: ser.topk_array(t, 0.25, quantize=True)}[encoding]
    _, meta = ser.flat_serialize({k: encode(v) for k, v in tree.items()})
    required = set(PAYLOADS["dftp_leaf"].required_names)
    for leaf in meta["leaves"]:
        check_payload("dftp_leaf", leaf)
        assert required <= set(leaf)
        assert (leaf.get("encoding") == "sparse") == encoding.startswith("topk")


def test_check_payload_runtime_companion():
    check_payload("generate_request", {"prompt": b"x", "n_tokens": 4})
    with pytest.raises(ValueError, match="unknown wire keys"):
        check_payload("generate_request", {"prompt": b"x", "n_tokens": 4, "bogus": 1})
    with pytest.raises(ValueError, match="missing required"):
        check_payload("generate_request", {"prompt": b"x"})
    with pytest.raises(KeyError):
        check_payload("no_such_format", {})


def test_registry_lints_clean_and_doc_agrees(monkeypatch):
    from distriflow_tpu_torch.analysis.wire_check import (
        _DOC_PATH,
        _doc_findings,
        _registry_findings,
    )

    assert _registry_findings() == []
    assert _doc_findings(_DOC_PATH) == []  # docs/ANALYSIS.md's wire tables
    bad = schema.WirePayload("dfcheck_fixture_fmt", 1, (
        schema.WireField("a", required=True),
        schema.WireField("late_req", required=True, since=2),
    ))
    monkeypatch.setitem(PAYLOADS, "dfcheck_fixture_fmt", bad)
    details = {f.detail for f in _registry_findings()}
    assert details == {"dfcheck_fixture_fmt.late_req:since-gt-version",
                       "dfcheck_fixture_fmt.late_req:required-late-field"}
    assert {f.path for f in _registry_findings()} == {"distriflow_tpu_torch/comm/schema.py"}


def test_loopback_server_payloads_satisfy_schema():
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.models.convert import lm_from_jax, random_lm_tree
    from distriflow_tpu_torch.models.transformer import TransformerConfig
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                            max_seq=48, dtype=torch.float32, use_flash_attention=False,
                            use_flash_decode=False)
    model = lm_from_jax(cfg, random_lm_tree(cfg, np.random.default_rng(0)), device="cpu")
    prompt = np.random.default_rng(1).integers(0, 64, (1, 7)).astype(np.int32)
    tap = chip_smoke._LivePayloads()
    server = InferenceServer(model, serving=ServingConfig(page_size=16)).setup()
    try:
        with tap.tap(InferenceClient(server.address).setup()) as client:
            assert client.generate(prompt, 4).shape == (1, 11)
            assert client.last_serving_meta["path"] == "slots"
            toks, scores = client.beam_search(prompt, 3, beam_size=2)
            assert toks.shape == (1, 10) and np.isfinite(scores).all()
            assert client.score(prompt, from_pos=2).shape == (1,)
    finally:
        server.stop()
    assert dict(tap.counts["serving"]) == {
        "generate_request": 1, "generate_ack": 1, "serving_meta": 1,
        "beam_request": 1, "score_request": 1, "direct_ack": 2}


def test_chip_smoke_wire_tap_holds_reports_and_leaves():
    from distriflow_tpu_torch.obs import Telemetry
    from distriflow_tpu_torch.obs.collector import ReportBuilder
    from distriflow_tpu_torch.utils import serialization as ser

    tap = chip_smoke._LivePayloads()
    tel = Telemetry()
    tel.counter("client_uploads_total", help="uploads").inc()
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with tap.wire():
        ReportBuilder(tel, "c1").build()
        ser.pack_bytes({"a": ser.serialize_array(t), "b": ser.quantize_array(t),
                        "c": ser.topk_array(t, 0.5)})
        # a report that drifted from its schema fails where it is built
        with pytest.raises(ValueError, match="unknown wire keys"):
            tap.check("wire", "report", {**ReportBuilder(tel, "c2").build(), "bogus": 1})
    assert tap.counts["wire"] == {"report": 2, "dftp_leaf": 3}
    assert tap.failures == ["wire/report: report: unknown wire keys ['bogus']"]
    with pytest.raises(AssertionError, match="failed their schema"):
        tap.report()
    assert dict(tap.leaf_kinds) == {"dense": 1, "int8": 1, "sparse": 1}
    # outside the block nothing is tapped
    ReportBuilder(tel, "c3").build()
    assert tap.counts["wire"]["report"] == 2
