"""Port of ``distriflow_tpu/client/inference_client.py``: remote generate
over the wire.

Counterpart to :class:`distriflow_tpu_torch.server.inference_server.InferenceServer`
(and wire-compatible with the JAX server): requests are synchronous decode
calls whose ack carries the result. ``beam_search`` and ``score`` raise the
server's ``{"error": ...}`` answer while the port's server lacks them.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

from distriflow_tpu_torch.comm.transport import ClientTransport
from distriflow_tpu_torch.obs.collector import ReportBuilder
from distriflow_tpu_torch.obs.telemetry import Telemetry, get_telemetry
from distriflow_tpu_torch.utils.serialization import (
    deserialize_array,
    pack_bytes,
    serialize_array,
    unpack_bytes,
)

DECODE_TIMEOUT_S = 120.0  # the first request may pay the server's kernel build


class RequestShed(RuntimeError):
    """The fleet router refused this request under queue pressure (SLO-
    tiered admission, docs/PERFORMANCE.md §7h). Carries the tier the
    request ran at and the queue depth that justified the shed; callers
    retry later or at a more urgent tier."""

    def __init__(self, tier: int, queue_depth: int):
        super().__init__(
            f"request shed at tier {tier} (queue depth {queue_depth})")
        self.tier = tier
        self.queue_depth = queue_depth


class RequestRefused(RuntimeError):
    """The server answered with a structured refusal instead of a result
    (e.g. ``{"refused": "draining"}`` from a draining replica addressed
    directly, without a router in front to fail the request over)."""

    def __init__(self, reason: str):
        super().__init__(f"request refused: {reason}")
        self.reason = reason


class InferenceClient:
    """Remote decoding against an :class:`InferenceServer`."""

    def __init__(
        self,
        address: str,
        timeout: float = DECODE_TIMEOUT_S,
        telemetry: Optional[Telemetry] = None,
        report_interval_s: float = 5.0,
    ):
        self.address = address
        self.timeout = timeout
        self.transport = ClientTransport(address)
        self._connected = False
        # scheduling metadata from the last generate ack ({"path":
        # "slots"|"direct", "queue_ms": ...}); None against servers that
        # predate continuous batching — the key is optional on the wire
        self.last_serving_meta: Optional[Dict[str, Any]] = None
        # fleet telemetry plane: inference clients have no Upload path, so
        # reports ride the heartbeat (docs/OBSERVABILITY.md §10).  0 disables.
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self.report_interval_s = float(report_interval_s)
        self.client_id = f"infer-{uuid.uuid4().hex[:12]}"
        self._report_builder = ReportBuilder(self.telemetry, self.client_id)
        self._last_report_t = 0.0
        self.transport.heartbeat_payload = self._heartbeat_report

    # -- lifecycle ---------------------------------------------------------

    def setup(self) -> "InferenceClient":
        # idempotent: ``with InferenceClient(...).setup() as c`` otherwise
        # dials twice (__enter__ calls setup again), and the stale first
        # connection's heartbeat can bind the fresh endpoint's write lock
        # to the abandoned event loop
        if not self._connected:
            self.transport.connect()
            self._connected = True
        return self

    def close(self) -> None:
        if self._connected:
            self.transport.close()
            self._connected = False

    def __enter__(self) -> "InferenceClient":
        return self.setup()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- API ---------------------------------------------------------------

    def model_info(self) -> Dict[str, Any]:
        return self._request("model_info", {})

    def generate(
        self,
        prompt: np.ndarray,
        n_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        tier: Optional[int] = None,
        request_id: Optional[str] = None,
    ) -> np.ndarray:
        """Remote :func:`distriflow_tpu_torch.models.generate.generate`; returns
        ``[B, P + n_tokens]`` int32 (``eos_id`` freezes finished rows).

        ``tier``/``request_id`` are router-plane extras (both optional on
        the wire, so pre-router servers keep working): the SLO priority
        class the fleet router sheds by, and an end-to-end idempotency
        key — resending the SAME request_id after a timeout returns the
        cached result instead of recomputing. Raises
        :class:`RequestShed` on a router shed and
        :class:`RequestRefused` on a draining replica's refusal."""
        payload = self._prompt_payload(prompt)  # dfcheck: payload generate_request
        payload.update(
            n_tokens=int(n_tokens), temperature=float(temperature),
            top_k=top_k, top_p=top_p, eos_id=eos_id, seed=int(seed),
        )
        if tier is not None:
            payload["tier"] = int(tier)
        if request_id is not None:
            payload["request_id"] = str(request_id)
        # the client originates the request trace: a root ``request`` span
        # whose ids ride the wire (docs/OBSERVABILITY.md §11); NOOP_SPAN ids
        # are empty strings, so disabled telemetry never stamps headers
        with self.telemetry.tracer.span(
                "request", op="generate",
                tier=int(tier) if tier is not None else 0) as sp:
            if sp.trace_id:
                payload["trace_id"] = sp.trace_id
                payload["span_id"] = sp.span_id
            ack = self._request("generate", payload)  # dfcheck: payload generate_ack
            self.last_serving_meta = ack.get("serving")
            if "result" not in ack:
                if ack.get("shed"):
                    raise RequestShed(int(ack.get("tier", -1)),
                                      int(ack.get("queue_depth", -1)))
                raise RequestRefused(str(ack.get("refused", ack)))
            result = unpack_bytes(ack["result"])
            return deserialize_array(result["tokens"])

    def beam_search(
        self,
        prompt: np.ndarray,
        n_tokens: int,
        beam_size: int = 4,
        length_penalty: float = 0.0,
        eos_id: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Remote beam search (the server's ``beam``); returns
        ``(tokens [B, P + n_tokens], scores [B])``."""
        payload = self._prompt_payload(prompt)  # dfcheck: payload beam_request
        payload.update(
            n_tokens=int(n_tokens), beam_size=int(beam_size),
            length_penalty=float(length_penalty), eos_id=eos_id,
        )
        with self.telemetry.tracer.span("request", op="beam") as sp:
            if sp.trace_id:
                payload["trace_id"] = sp.trace_id
                payload["span_id"] = sp.span_id
            result = unpack_bytes(self._request("beam", payload)["result"])
        return deserialize_array(result["tokens"]), deserialize_array(result["scores"])

    def score(self, tokens: np.ndarray, from_pos: int = 1) -> np.ndarray:
        """Remote sequence scoring (the server's ``score``): teacher-
        forced ``log P(tokens[:, from_pos:] | prefix)`` per row."""
        payload = self._prompt_payload(tokens)  # dfcheck: payload score_request
        payload["from_pos"] = int(from_pos)
        with self.telemetry.tracer.span("request", op="score") as sp:
            if sp.trace_id:
                payload["trace_id"] = sp.trace_id
                payload["span_id"] = sp.span_id
            result = unpack_bytes(self._request("score", payload)["result"])
        return deserialize_array(result["scores"])

    # -- internals ---------------------------------------------------------

    def _heartbeat_report(self) -> Optional[Dict[str, Any]]:
        """Interval-gated telemetry report riding the heartbeat payload."""
        if self.report_interval_s <= 0 or not self.telemetry.enabled:
            return None
        now = time.monotonic()
        if now - self._last_report_t < self.report_interval_s:
            return None
        self._last_report_t = now
        return self._report_builder.build()

    def _request(self, event: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        result = self.transport.request(event, payload, timeout=self.timeout)
        if result is None:
            # the transport acks None when the server handler raised
            raise RuntimeError(
                f"server failed to handle {event!r} (bad arguments, or see "
                "server log)"
            )
        if "error" in result:
            raise NotImplementedError(f"server refused {event!r}: {result['error']}")
        return result

    @staticmethod
    def _prompt_payload(prompt: np.ndarray) -> Dict[str, Any]:
        arr = np.asarray(prompt, np.int32)
        if arr.ndim != 2:
            raise ValueError(f"prompt must be [B, P], got shape {arr.shape}")
        return {"prompt": pack_bytes({"tokens": serialize_array(arr)})}
