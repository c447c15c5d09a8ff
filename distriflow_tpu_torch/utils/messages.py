"""Port of ``distriflow_tpu/utils/messages.py`` (copied with its imports
rewritten): the wire protocol's message schema, with the same dict form on
the wire as the JAX package's.

Re-design of the reference's two-event protocol and message types
(``src/common/utils.ts:109-155``): ``Events.Download``/``Events.Upload``,
``ModelMsg``/``GradientMsg`` ``{version, vars}``, ``DataMsg``, ``UploadMsg``,
``DownloadMsg``. These survive only at the host-coordination edge
(async dispatch, multi-process federated mode); the sync-SGD path never
serializes gradients.

Messages encode to/from plain dicts of JSON-able values + packed tensor
buffers (``distriflow_tpu_torch.utils.serialization.pack_bytes``), framed by
``distriflow_tpu_torch.comm.transport``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from distriflow_tpu_torch.utils.serialization import (
    SerializedArray,
    pack_bytes,
    unpack_bytes,
)


class Events(str, enum.Enum):
    """Protocol events (reference ``src/common/utils.ts:115-118``)."""

    Download = "downloadVars"
    Upload = "uploadVars"
    Resync = "resyncVars"
    Connect = "connect"
    Disconnect = "disconnect"


@dataclass
class ModelMsg:
    """Versioned weights (reference ``ModelMsg {version, vars}``, ``utils.ts:120-123``).

    ``delta_base`` (optional, absent on the wire when unset — old frames
    parse fine) marks a *delta broadcast*: ``vars`` holds per-leaf
    ``new - base`` for float leaves (full values for non-float leaves)
    against the params of version ``delta_base``. A receiver whose
    installed version is not ``delta_base`` must discard the message and
    request a full resync (``Events.Resync``) instead of installing.
    """

    version: str
    vars: Dict[str, SerializedArray]
    delta_base: Optional[str] = None

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"version": self.version, "vars": pack_bytes(self.vars)}
        if self.delta_base is not None:
            d["delta_base"] = self.delta_base
        return d

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "ModelMsg":
        return ModelMsg(version=d["version"], vars=unpack_bytes(d["vars"]),
                        delta_base=d.get("delta_base"))


# A gradient message has the same shape as a model message: version it was
# computed against + serialized tensors (reference ``utils.ts:125-128``).
GradientMsg = ModelMsg


@dataclass
class DataMsg:
    """A dispatched batch (reference ``DataMsg {batch, epoch, x, y}``, ``utils.ts:130-135``)."""

    batch: int
    epoch: int
    x: SerializedArray
    y: SerializedArray

    def to_wire(self) -> Dict[str, Any]:
        return {
            "batch": self.batch,
            "epoch": self.epoch,
            "xy": pack_bytes({"x": self.x, "y": self.y}),
        }

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "DataMsg":
        xy = unpack_bytes(d["xy"])
        return DataMsg(batch=d["batch"], epoch=d["epoch"], x=xy["x"], y=xy["y"])


@dataclass
class UploadMsg:
    """Client -> server (reference ``UploadMsg``, ``utils.ts:144-149``).

    ``update_id`` (beyond the reference) is a client-generated unique id
    for the update carried by this message. Servers keep a bounded LRU of
    recently applied ids and ack duplicates without re-applying, which is
    what makes upload *retries* safe: an ack that timed out may or may not
    have been applied, so the client resends the same message — same
    ``update_id`` — and the gradient lands exactly once either way.
    ``AbstractClient.upload`` stamps one automatically when unset.

    ``trace_id``/``span_id`` are the wire-tracing header (see
    ``distriflow_tpu_torch.obs.tracing``): ``trace_id`` identifies the update's
    end-to-end trace and — like ``update_id`` — is stamped once and reused
    by every retry/duplicate of the same update, so the server-side apply
    span joins the client-side upload span even across reconnects.
    ``span_id`` is the sending span's id; the receiver records it as its
    span's ``parent_id``.

    ``report`` (optional, absent on the wire when unset — old frames
    parse fine) piggybacks a fleet telemetry report
    (``distriflow_tpu_torch.obs.collector``) on the upload metadata every
    ``telemetry_report_interval_s``, so shipping client metrics costs no
    extra round trips. Retries resend the identical report; the
    collector's seq gating makes that idempotent.
    """

    client_id: str
    gradients: Optional[GradientMsg] = None
    batch: Optional[int] = None
    metrics: Optional[List[float]] = None
    update_id: Optional[str] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    report: Optional[Dict[str, Any]] = None

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"client_id": self.client_id}
        if self.gradients is not None:
            d["gradients"] = self.gradients.to_wire()
        if self.batch is not None:
            d["batch"] = self.batch
        if self.metrics is not None:
            d["metrics"] = list(self.metrics)
        if self.update_id is not None:
            d["update_id"] = self.update_id
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.report is not None:
            d["report"] = self.report
        return d

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "UploadMsg":
        return UploadMsg(
            client_id=d["client_id"],
            gradients=ModelMsg.from_wire(d["gradients"]) if "gradients" in d else None,
            batch=d.get("batch"),
            metrics=d.get("metrics"),
            update_id=d.get("update_id"),
            trace_id=d.get("trace_id"),
            span_id=d.get("span_id"),
            report=d.get("report"),
        )


@dataclass
class DownloadMsg:
    """Server -> client (reference ``DownloadMsg``, ``utils.ts:151-155``).

    ``hyperparams`` carries server-pushed client hyperparameters (the server
    can centrally set them for every client, reference
    ``src/server/abstract_server.ts:87``).

    ``trace_id``/``span_id``: wire-tracing header, mirroring ``UploadMsg``.
    A dispatch carrying a batch starts the trace; the client copies the
    ``trace_id`` into the resulting upload so dispatch → train → upload →
    apply is one trace.
    """

    model: ModelMsg
    hyperparams: Dict[str, Any] = field(default_factory=dict)
    data: Optional[DataMsg] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"model": self.model.to_wire(), "hyperparams": dict(self.hyperparams)}
        if self.data is not None:
            d["data"] = self.data.to_wire()
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.span_id is not None:
            d["span_id"] = self.span_id
        return d

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "DownloadMsg":
        return DownloadMsg(
            model=ModelMsg.from_wire(d["model"]),
            hyperparams=d.get("hyperparams", {}),
            data=DataMsg.from_wire(d["data"]) if d.get("data") is not None else None,
            trace_id=d.get("trace_id"),
            span_id=d.get("span_id"),
        )
