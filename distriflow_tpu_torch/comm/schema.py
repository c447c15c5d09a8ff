"""Port of ``distriflow_tpu/comm/schema.py`` (copied field for field).

Single-source wire-schema registry for every DistriFlow message format.

Every dict that crosses a process boundary — the UploadMsg/DownloadMsg
training envelopes, the serving ``generate``/``beam``/``score`` payloads and
acks, the telemetry report (v1), the ``fleet_stats`` poll payload, and the
dftp-flat per-leaf metadata (v1 dense, v2 sparse) — is declared here exactly
once.  Three consumers keep it honest:

* ``distriflow_tpu_torch.analysis.wire_check`` statically checks every
  construction and field-read site in ``comm/``, ``client/``, ``server/``,
  ``fleet/`` and ``obs/collector.py`` against these tables (via
  ``# dfcheck: payload`` bindings and the message-class conventions).
* ``docs/ANALYSIS.md`` carries rendered wire tables; the analyzer fails when
  doc and registry drift in either direction.
* Tests cross-check the version constants against the runtime encoders
  (``REPORT_VERSION``, the dftp-flat ``_VERSION``/``_VERSION_SPARSE``).

Versioning discipline (enforced by the ``wire-version`` lint): a field added
after a format shipped must either bump the format ``version`` (and carry
``since=<new version>``) or be optional with an absent-on-wire default, and
readers must use ``.get`` for any field that can be absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "WireField",
    "WireMessage",
    "WirePayload",
    "MESSAGES",
    "PAYLOADS",
    "check_payload",
]


@dataclasses.dataclass(frozen=True)
class WireField:
    """One key of a wire dict.

    ``required`` — always present on the wire (readers may use ``d[k]``).
    ``since`` — first format version carrying the field; fields with
    ``since`` greater than 1 are absent when an older writer produced the
    dict, so readers must guard or ``.get`` them.
    ``payload`` / ``message`` — the schema of the field's value when it is
    itself a registered payload dict or wire message (lets the checker
    follow chained reads like ``msg.gradients.version``).
    ``wire`` / ``attr`` — whether the field exists as an on-the-wire key /
    as a dataclass attribute.  Usually both; ``DataMsg`` packs its ``x``/
    ``y`` attributes into a single wire key ``xy`` (attrs with
    ``wire=False``, a key with ``attr=False``).
    """

    name: str
    required: bool = False
    since: int = 1
    payload: Optional[str] = None
    message: Optional[str] = None
    wire: bool = True
    attr: bool = True


@dataclasses.dataclass(frozen=True)
class WireMessage:
    """A ``to_wire``/``from_wire`` dataclass envelope (utils/messages.py)."""

    name: str
    version: int
    fields: Tuple[WireField, ...]

    def field(self, name: str) -> Optional[WireField]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    @property
    def required_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.required and f.wire)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    @property
    def wire_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.wire)

    @property
    def attr_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.attr)


@dataclasses.dataclass(frozen=True)
class WirePayload:
    """A bare-dict wire format (no dataclass wrapper): request/ack payloads,
    the telemetry report, fleet_stats, dftp-flat leaf metadata."""

    name: str
    version: int
    fields: Tuple[WireField, ...]

    def field(self, name: str) -> Optional[WireField]:
        for f in self.fields:
            if f.name == name:
                return f
        return None

    @property
    def required_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields if f.required)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)


def _msg(name: str, version: int, *fields: WireField) -> WireMessage:
    return WireMessage(name=name, version=version, fields=tuple(fields))


def _payload(name: str, version: int, *fields: WireField) -> WirePayload:
    return WirePayload(name=name, version=version, fields=tuple(fields))


# ---------------------------------------------------------------------------
# message envelopes (utils/messages.py dataclasses)
# ---------------------------------------------------------------------------

MESSAGES: Dict[str, WireMessage] = {}

MESSAGES["ModelMsg"] = _msg(
    "ModelMsg", 1,
    WireField("version", required=True),
    WireField("vars", required=True),
    # absent-on-wire unless the payload is a delta against a base version
    WireField("delta_base"),
)

# GradientMsg is a wire alias of ModelMsg ("version" = client model version,
# "vars" = serialized gradient tree) — one schema, two names, so annotated
# sites can use either.
MESSAGES["GradientMsg"] = dataclasses.replace(MESSAGES["ModelMsg"],
                                              name="GradientMsg")

MESSAGES["DataMsg"] = _msg(
    "DataMsg", 1,
    WireField("batch", required=True),
    WireField("epoch", required=True),
    # the x/y arrays are dataclass attributes packed into one wire key
    WireField("x", required=True, wire=False),
    WireField("y", required=True, wire=False),
    WireField("xy", required=True, attr=False),
)

MESSAGES["UploadMsg"] = _msg(
    "UploadMsg", 1,
    WireField("client_id", required=True),
    WireField("gradients", message="GradientMsg"),
    WireField("batch"),
    WireField("metrics"),
    WireField("update_id"),
    WireField("trace_id"),
    WireField("span_id"),
    WireField("report", payload="report"),
)

MESSAGES["DownloadMsg"] = _msg(
    "DownloadMsg", 1,
    WireField("model", required=True, message="ModelMsg"),
    WireField("hyperparams", required=True),
    WireField("data", message="DataMsg"),
    WireField("trace_id"),
    WireField("span_id"),
)


# ---------------------------------------------------------------------------
# bare-dict payload formats
# ---------------------------------------------------------------------------

PAYLOADS: Dict[str, WirePayload] = {}

#: telemetry client report (obs/collector.py, REPORT_VERSION = 1).  The
#: ReportBuilder emits every key unconditionally; ingest tolerates partial dicts
#: defensively but the format requires all of them.
PAYLOADS["report"] = _payload(
    "report", 1,
    WireField("v", required=True),
    WireField("client_id", required=True),
    WireField("host", required=True),
    WireField("pid", required=True),
    WireField("seq", required=True),
    WireField("full", required=True),
    WireField("time", required=True),
    WireField("counters", required=True),
    WireField("gauges", required=True),
    WireField("hists", required=True),
    WireField("spans", required=True),
)

#: serving replica stats poll (inference_server `_on_fleet_stats` ->
#: fleet/registry.py).  Version 2 (round 19) adds the replica-authoritative
#: warm set — ``warm_prefixes`` is a list of ``[chain_hash_hex, hit_count]``
#: pairs (the hottest prefix pages by per-hash hit counters) and
#: ``prefix_entries`` the total prefix-map population — so router shadow
#: maps rebuild from replica truth instead of routing history alone, and
#: the autoscaler can rank arcs by coldness.  Both are ``since=2``: a v1
#: replica omits them and the registry reads them with ``.get``.
PAYLOADS["fleet_stats"] = _payload(
    "fleet_stats", 2,
    WireField("queue_depth", required=True),
    WireField("slots_active", required=True),
    WireField("max_slots", required=True),
    WireField("draining", required=True),
    WireField("page_size", required=True),
    WireField("prefix_sharing", required=True),
    WireField("page_occupancy", required=True),
    WireField("free_pages", required=True),
    WireField("prefix_hits", required=True),
    WireField("speculate_k", required=True),
    WireField("spec_accept_per_step", required=True),
    WireField("evicted_prefixes", required=True),
    WireField("warm_prefixes", since=2),
    WireField("prefix_entries", since=2),
)

#: one consistent-ring membership change (fleet/router.py `_sync_ring` ->
#: bounded event log + run timeline).  ``epoch`` orders events without
#: timestamps; ``members`` is the post-change membership; ``event`` names
#: the transition (join/leave/drain/undrain/sync) and ``replica`` the
#: replica that moved (absent for multi-member syncs).
PAYLOADS["ring_membership"] = _payload(
    "ring_membership", 1,
    WireField("epoch", required=True),
    WireField("vnodes", required=True),
    WireField("members", required=True),
    WireField("event"),
    WireField("replica"),
)

#: best-effort cancel of the LOSING hedge attempt (fleet/router.py ->
#: inference_server `_on_hedge_cancel`).  Correctness never depends on it —
#: the replica-side dedup/in-flight gate already suppresses the duplicate —
#: it just frees the loser's slot instead of computing an unread result.
PAYLOADS["hedge_cancel"] = _payload(
    "hedge_cancel", 1,
    WireField("request_id", required=True),
)

#: hedge_cancel ack: how many in-flight admissions were flagged (0 when the
#: request already finished or was never admitted on this replica).
PAYLOADS["hedge_cancel_ack"] = _payload(
    "hedge_cancel_ack", 1,
    WireField("request_id", required=True),
    WireField("cancelled", required=True),
)

#: generate request (inference_client -> inference_server)
PAYLOADS["generate_request"] = _payload(
    "generate_request", 1,
    WireField("prompt", required=True),
    WireField("n_tokens", required=True),
    WireField("temperature"),
    WireField("top_k"),
    WireField("top_p"),
    WireField("eos_id"),
    WireField("seed"),
    WireField("tier"),
    WireField("request_id"),
    WireField("trace_id"),
    WireField("span_id"),
)

#: generate ack — exactly one of {result, refused, shed} shapes; every key
#: is optional so readers must probe with ``in`` / ``.get``.
PAYLOADS["generate_ack"] = _payload(
    "generate_ack", 1,
    WireField("result"),
    WireField("serving", payload="serving_meta"),
    WireField("refused"),
    WireField("shed"),
    WireField("tier"),
    WireField("queue_depth"),
    WireField("trace_id"),
)

#: scheduling metadata riding a successful generate ack
PAYLOADS["serving_meta"] = _payload(
    "serving_meta", 1,
    WireField("path", required=True),
    WireField("queue_ms"),
    WireField("prefix_tokens"),
    WireField("ttft_ms"),
    WireField("tpot_ms"),
    # injected by the fleet router on the way back to the caller
    # ({replica, affinity_depth, failovers, tier}); absent on direct acks
    WireField("router"),
)

#: beam-search request payload
PAYLOADS["beam_request"] = _payload(
    "beam_request", 1,
    WireField("prompt", required=True),
    WireField("n_tokens", required=True),
    WireField("beam_size"),
    WireField("length_penalty"),
    WireField("eos_id"),
    WireField("trace_id"),
    WireField("span_id"),
)

#: sequence-scoring request payload
PAYLOADS["score_request"] = _payload(
    "score_request", 1,
    WireField("prompt", required=True),
    WireField("from_pos"),
    WireField("trace_id"),
    WireField("span_id"),
)

#: direct-path ack for beam/score: always a packed result
PAYLOADS["direct_ack"] = _payload(
    "direct_ack", 1,
    WireField("result", required=True),
    WireField("trace_id"),
)

#: per-client hyperparam override (server adaptive controller ->
#: AbstractServer.set_client_hyperparams -> DownloadMsg.hyperparams merge).
#: A sparse patch over ClientHyperparams: every key optional, only the
#: knobs the controller actually moved are present.  The merged result is
#: validated against ClientHyperparams before it ever reaches the wire.
PAYLOADS["hyperparam_override"] = _payload(
    "hyperparam_override", 1,
    WireField("batch_size"),
    WireField("learning_rate"),
    WireField("epochs"),
    WireField("examples_per_update"),
    WireField("gradient_compression"),
    WireField("topk_fraction"),
    WireField("inflight_window"),
    WireField("telemetry_report_interval_s"),
)

#: one adaptive-controller decision (fleet/controller.py action log +
#: doctor/bench assertions).  ``client`` is absent for fleet-wide actions
#: (dispatch-window cap moves); ``observed`` echoes the breach detail that
#: triggered the move.  The fleet autoscaler logs the same format with
#: action scale_out/scale_in: ``replica`` names the member that moved,
#: ``via`` how (undrain/add), ``replicas_live`` the post-action live count.
PAYLOADS["controller_action"] = _payload(
    "controller_action", 1,
    WireField("action", required=True),
    WireField("band", required=True),
    WireField("client"),
    WireField("knob"),
    WireField("old"),
    WireField("new"),
    WireField("observed"),
    WireField("replica"),
    WireField("via"),
    WireField("replicas_live"),
)

#: dftp-flat per-leaf metadata — version 1 is dense-only; version 2 adds the
#: sparse leaf variant (encoding="sparse" + index chunk).  The v2 fields are
#: ``since=2`` so readers must guard on ``encoding`` before touching them.
PAYLOADS["dftp_leaf"] = _payload(
    "dftp_leaf", 2,
    WireField("name", required=True),
    WireField("dtype", required=True),
    WireField("shape", required=True),
    WireField("byte_offset", required=True),
    WireField("nbytes", required=True),
    WireField("scale"),
    WireField("encoding", since=2),
    WireField("index_dtype", since=2),
    WireField("indices_offset", since=2),
    WireField("indices_nbytes", since=2),
)


def check_payload(name: str, d: Dict[str, object]) -> None:
    """Runtime companion to the static check: raise ``ValueError`` when a
    dict does not satisfy a registered payload schema (unknown key, missing
    required key).  Used by tests and debug assertions; production paths
    rely on the static analyzer instead so the hot path pays nothing."""
    schema = PAYLOADS.get(name)
    if schema is None:
        raise KeyError(f"unknown payload schema: {name!r}")
    known = set(schema.names)
    unknown = sorted(set(map(str, d)) - known)
    if unknown:
        raise ValueError(f"{name}: unknown wire keys {unknown}")
    missing = sorted(set(schema.required_names) - set(map(str, d)))
    if missing:
        raise ValueError(f"{name}: missing required wire keys {missing}")
