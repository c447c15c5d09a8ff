"""Port of ``distriflow_tpu/comm/transport.py`` (copied with its imports rewritten).

Asyncio TCP transport: the socket.io replacement.

The reference's cross-process story is socket.io 2.x over WebSocket
(hub-and-spoke, server-centric, binary payloads, emit-with-ack;
SURVEY.md §2.4). This module provides the same primitives natively:

- length-prefixed, CRC32-checksummed binary frames (codec.py payloads)
  over TCP — a corrupted frame raises :class:`FrameCorruptionError` and
  resets the connection instead of decoding garbage;
- ``emit(event, payload)`` fire-and-forget and ``request`` (emit + ack)
  with timeouts — the reference's 5 s upload-ack and 10 s connect
  timeouts are preserved as defaults (``src/client/abstract_client.ts:12-13``);
- server-side broadcast to all connected clients
  (``server.sockets.emit``, ``federated_server.ts:80``);
- connection/disconnection callbacks;
- heartbeat-based failure detection (beyond the reference, which has no
  liveness checks at all): clients ping every ``heartbeat_interval``, the
  server echoes and evicts clients silent past ``heartbeat_timeout`` —
  eviction runs the normal disconnect path, so outstanding batches are
  requeued; clients detect a vanished server via ``on_server_lost``;
- a typed error hierarchy (:class:`TransportError` and friends) so
  callers can tell retryable failures (ack timeout, connection lost)
  from fatal ones;
- deterministic fault injection (:class:`FaultPlan`): either endpoint
  can be configured to drop, delay, duplicate, or corrupt outbound
  frames — or reset the connection — at seeded per-fault rates and/or
  at scripted points ("reset after the 3rd Upload"), which is how the
  retry/reconnect/dedup machinery above is proven in tests
  (``tests/test_chaos.py``) without flaky real-network failures.

Both endpoints run their event loop in a background thread so the public
API is synchronous (trainers and tests are synchronous; the reference's
node event loop maps onto this thread).

On TPU pods this transport only carries *host coordination* for the
multi-process federated mode (client-held data). Device-to-device tensor
movement never goes through here — that is ICI's job (see
``distriflow_tpu/parallel``).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import random
import struct
import threading
import sys
import time
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from distriflow_tpu_torch.comm.codec import checksum, decode, encode
from distriflow_tpu_torch.obs.telemetry import Telemetry, get_telemetry

CONNECT_TIMEOUT_S = 10.0  # reference abstract_client.ts:12
ACK_TIMEOUT_S = 5.0  # reference abstract_client.ts:13
# Failure detection (no reference counterpart — the reference has no
# heartbeats, retries, or liveness checks at all; SURVEY.md §5 "failure
# detection": only connect/ack timeouts surface hangs there). A worker that
# dies silently mid-batch would otherwise hold its batch until epoch wrap.
HEARTBEAT_INTERVAL_S = 2.0
HEARTBEAT_TIMEOUT_S = 10.0
_HB_EVENT = "__hb__"


# -- typed errors ----------------------------------------------------------
# Multiple inheritance keeps every pre-hierarchy except clause working:
# code catching TimeoutError still catches AckTimeout, code catching
# ConnectionError/OSError still catches ConnectionLost.


class TransportError(Exception):
    """Base of all transport-layer failures."""


class AckTimeout(TransportError, TimeoutError):
    """A request's ack did not arrive in time. Retryable: the peer may have
    processed the message (retry with the same ``update_id`` — the server
    dedups)."""


class ConnectionLost(TransportError, ConnectionError):
    """The connection dropped (reset, EOF, refused, or deliberately torn
    down by fault injection). Retryable after a reconnect."""


class FrameCorruptionError(TransportError):
    """A frame failed its CRC32 check. The connection is reset — a stream
    that has lost framing cannot be resynchronized."""


# -- framing ---------------------------------------------------------------

_HDR = struct.Struct("<QI")  # payload length + CRC32 of the payload
MAX_FRAME = 1 << 33  # 8 GiB safety bound


def frame_bytes(payload: bytes) -> bytes:
    """Header + payload for one wire frame (exposed for tests/tools that
    speak the protocol over a raw socket)."""
    return _HDR.pack(len(payload), checksum(payload)) + payload


async def _write_frame(
    writer: asyncio.StreamWriter, payload: bytes, corrupt: bool = False
) -> None:
    header = _HDR.pack(len(payload), checksum(payload))
    if corrupt:  # fault injection: flip a payload byte AFTER the CRC is
        # computed, so the receiver's check must catch it
        payload = payload[:-1] + bytes([payload[-1] ^ 0xFF]) if payload else b"\x00"
    writer.write(header + payload)
    await writer.drain()


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(_HDR.size)
    n, crc = _HDR.unpack(header)
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds MAX_FRAME")
    payload = await reader.readexactly(n)
    if checksum(payload) != crc:
        raise FrameCorruptionError(
            f"frame CRC mismatch ({n} bytes): wire corruption or protocol desync"
        )
    return payload


# -- fault injection -------------------------------------------------------

FAULT_ACTIONS = ("drop", "delay", "duplicate", "corrupt", "reset")


@dataclasses.dataclass
class FaultDecision:
    """What the transport should do with one outbound frame."""

    drop: bool = False
    delay_s: float = 0.0
    duplicate: bool = False
    corrupt: bool = False
    reset: bool = False


_NO_FAULT = FaultDecision()


@dataclasses.dataclass
class ScriptedFault:
    """One deterministic fault: apply ``action`` to the ``nth`` (1-based)
    outbound frame carrying ``event`` — e.g.
    ``ScriptedFault(event="uploadVars", nth=3, action="reset")`` tears the
    connection down exactly when the 3rd Upload is being sent."""

    event: str
    nth: int
    action: str
    delay_s: float = 0.05

    def __post_init__(self) -> None:
        if self.action not in FAULT_ACTIONS:
            raise ValueError(f"action must be one of {FAULT_ACTIONS}, got {self.action!r}")
        if self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")


class FaultPlan:
    """Seeded, deterministic fault injector consulted at frame boundaries.

    Install on either endpoint (``ServerTransport(..., fault_plan=...)`` /
    ``ClientTransport(..., fault_plan=...)``); every outbound frame (except
    ``exempt`` events — heartbeats by default) gets one decision:

    - ``drop``: the frame is silently not sent (a lost packet);
    - ``delay``: the frame is sent after ``delay_s`` (network latency spike);
    - ``duplicate``: the frame is sent twice (at-least-once delivery);
    - ``corrupt``: a payload byte is flipped after the CRC is computed
      (wire corruption — the receiver resets the connection);
    - ``reset``: the connection is closed instead of sending (peer crash).

    Rates are per-fault-type probabilities sampled from a private seeded
    RNG — the same seed and frame sequence always yields the same fault
    sequence (one RNG draw per fault type per frame, so decisions stay
    aligned regardless of which faults fire). ``schedule`` adds exact
    scripted faults on top (see :class:`ScriptedFault`); scripted entries
    take precedence over rates for their frame. Thread-safe.
    """

    def __init__(
        self,
        seed: int = 0,
        drop: float = 0.0,
        delay: float = 0.0,
        duplicate: float = 0.0,
        corrupt: float = 0.0,
        reset: float = 0.0,
        delay_s: float = 0.02,
        schedule: Sequence[ScriptedFault] = (),
        exempt: Iterable[str] = (_HB_EVENT,),
    ):
        self.rates = {"drop": drop, "delay": delay, "duplicate": duplicate,
                      "corrupt": corrupt, "reset": reset}
        for name, rate in self.rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} rate must be in [0, 1], got {rate}")
        self.delay_s = delay_s
        self.schedule = list(schedule)
        self.exempt = frozenset(exempt)
        self._rng = random.Random(seed)  # guarded-by: _lock
        self._lock = threading.Lock()
        self._counts: collections.Counter = collections.Counter()  # frames seen  # guarded-by: _lock
        self.injected: collections.Counter = collections.Counter()  # faults fired  # guarded-by: _lock

    def frames_seen(self, event: str) -> int:
        with self._lock:
            return self._counts[event]

    def seen(self) -> Dict[str, int]:
        """Copy of all per-event offered-frame counts (exempt events are
        never counted); the doctor reconciles these totals against the
        transport's ``transport_frames_offered_total`` counters."""
        with self._lock:
            return dict(self._counts)

    def decide(self, event: str) -> FaultDecision:
        """One decision for one outbound frame carrying ``event``."""
        if event in self.exempt:
            return _NO_FAULT
        with self._lock:
            self._counts[event] += 1
            n = self._counts[event]
            for s in self.schedule:
                if s.event == event and s.nth == n:
                    self.injected[s.action] += 1
                    d = FaultDecision()
                    if s.action == "delay":
                        d.delay_s = s.delay_s
                    else:
                        setattr(d, s.action, True)
                    return d
            # fixed draw count per frame: the RNG stream stays aligned with
            # the frame sequence no matter which faults fire
            draws = {a: self._rng.random() for a in FAULT_ACTIONS}
        d = FaultDecision()
        if self.rates["reset"] and draws["reset"] < self.rates["reset"]:
            d.reset = True  # precludes everything else
        elif self.rates["drop"] and draws["drop"] < self.rates["drop"]:
            d.drop = True
        else:
            if self.rates["delay"] and draws["delay"] < self.rates["delay"]:
                d.delay_s = self.delay_s
            if self.rates["duplicate"] and draws["duplicate"] < self.rates["duplicate"]:
                d.duplicate = True
            if self.rates["corrupt"] and draws["corrupt"] < self.rates["corrupt"]:
                d.corrupt = True
        fired = [a for a in ("drop", "duplicate", "corrupt", "reset") if getattr(d, a)]
        if d.delay_s > 0:
            fired.append("delay")
        if fired:
            with self._lock:
                self.injected.update(fired)
        return d


class _Endpoint:
    """Shared emit/ack machinery for one connection.

    Telemetry contract: the per-action fault counters below are bumped at
    the exact site each :class:`FaultDecision` field is *applied* — one
    increment per fired decision, never per copy written — so across all
    endpoints sharing a plan, ``transport_frames_<action>_total`` sums to
    exactly ``FaultPlan.injected[action]`` (the reconciliation the doctor
    enforces).
    """

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        writer: asyncio.StreamWriter,
        fault_plan: Optional[FaultPlan] = None,
        telemetry: Optional[Telemetry] = None,
        role: str = "server",
    ):
        self.loop = loop
        self.writer = writer
        self.fault_plan = fault_plan
        self._acks: Dict[str, asyncio.Future] = {}
        self._write_lock = asyncio.Lock()
        t = telemetry if telemetry is not None else get_telemetry()
        # handles cached once: the send/ack hot path does no registry lookups
        self._c_sent = t.counter(
            "transport_frames_sent_total", role=role,
            help="frames actually written to the wire")
        self._c_offered = t.counter(
            "transport_frames_offered_total", role=role,
            help="frames offered to the fault plan (pre-loss)")
        self._c_dropped = t.counter(
            "transport_frames_dropped_total", role=role,
            help="frames dropped by the injected fault plan")
        self._c_duplicated = t.counter(
            "transport_frames_duplicated_total", role=role,
            help="frames duplicated by the injected fault plan")
        self._c_corrupted = t.counter(
            "transport_frames_corrupted_total", role=role,
            help="frames corrupted in flight by the fault plan")
        self._c_delayed = t.counter(
            "transport_frames_delayed_total", role=role,
            help="frames delayed in flight by the fault plan")
        self._c_resets = t.counter(
            "transport_resets_total", role=role,
            help="connection resets injected by the fault plan")
        self._h_ack = t.histogram(
            "transport_ack_latency_ms", role=role,
            help="send-to-ack round trip per frame (ms)")

    async def _send(self, msg: Dict[str, Any]) -> None:
        copies, corrupt = 1, False
        if self.fault_plan is not None:
            event = str(msg.get("event", ""))
            if event not in self.fault_plan.exempt:
                # mirrors FaultPlan._counts exactly (exempt frames skipped)
                self._c_offered.inc()
            d = self.fault_plan.decide(event)
            if d.reset:
                self._c_resets.inc()
                self.writer.close()
                raise ConnectionLost("fault injection: connection reset")
            if d.drop:
                self._c_dropped.inc()
                return  # the frame vanishes; acks/retries must recover
            if d.delay_s > 0:
                self._c_delayed.inc()
                await asyncio.sleep(d.delay_s)
            if d.duplicate:
                self._c_duplicated.inc()
                copies = 2
            if d.corrupt:
                self._c_corrupted.inc()
                corrupt = True
        async with self._write_lock:
            for _ in range(copies):
                await _write_frame(self.writer, encode(msg), corrupt=corrupt)
                self._c_sent.inc()

    def fail_pending(self, exc: BaseException) -> None:
        """Fail every in-flight request (connection torn down): retryable
        callers see ConnectionLost immediately instead of burning out their
        full ack timeout against a dead socket."""
        for fut in list(self._acks.values()):
            if not fut.done():
                fut.set_exception(exc)

    async def emit_async(self, event: str, payload: Any) -> None:
        await self._send({"event": event, "payload": payload})

    async def request_async(self, event: str, payload: Any, timeout: float) -> Any:
        msg_id = uuid.uuid4().hex
        fut = self.loop.create_future()
        self._acks[msg_id] = fut
        t0 = time.perf_counter()
        try:
            await self._send({"event": event, "payload": payload, "msg_id": msg_id})
            result = await asyncio.wait_for(fut, timeout)
            # only acked round-trips land in the latency histogram —
            # timeouts/drops are visible in the counters instead
            self._h_ack.observe((time.perf_counter() - t0) * 1000.0)
            return result
        finally:
            self._acks.pop(msg_id, None)

    def handle_ack(self, msg: Dict[str, Any]) -> None:
        fut = self._acks.get(msg.get("ack_id", ""))
        if fut is not None and not fut.done():
            fut.set_result(msg.get("result"))


class ServerTransport:
    """Hub endpoint: accepts clients, dispatches events, broadcasts."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_interval: float = HEARTBEAT_INTERVAL_S,
        heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S,
        fault_plan: Optional[FaultPlan] = None,
        telemetry: Optional[Telemetry] = None,
    ):
        self.host = host
        self.port = port
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout  # 0 disables reaping
        self.fault_plan = fault_plan  # chaos testing: shared by all connections
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self._c_received = self.telemetry.counter(
            "transport_frames_received_total", role="server",
            help="frames received and framed off the wire")
        self._c_corrupt_rx = self.telemetry.counter(
            "transport_frames_corrupt_rx_total", role="server",
            help="received frames rejected by checksum/decode")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._clients: Dict[str, _Endpoint] = {}
        self._last_seen: Dict[str, float] = {}
        self._handlers: Dict[str, Callable[[str, Any], Any]] = {}
        self.on_connect: Optional[Callable[[str], Any]] = None
        self.on_disconnect: Optional[Callable[[str], Any]] = None
        # fleet telemetry plane: non-None heartbeat payloads (inference
        # clients piggyback reports on their beats) are handed here
        self.on_heartbeat: Optional[Callable[[str, Any], None]] = None
        self._started = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServerTransport":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("server transport failed to start")
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            self._server = await asyncio.start_server(
                self._handle_client, self.host, self.port
            )
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            if self.heartbeat_timeout > 0:
                self._loop.create_task(self._reap_dead_clients())
            async with self._server:
                await self._server.serve_forever()

        try:
            self._loop.run_until_complete(main())
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def stop(self) -> None:
        if self._loop is None or self._loop.is_closed():
            return  # idempotent: second stop (test teardown) is a no-op
        loop = self._loop

        def _shutdown():
            for task in asyncio.all_tasks(loop):
                task.cancel()

        try:
            loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            return  # loop closed between the check and the call
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- events ------------------------------------------------------------

    def on(self, event: str, handler: Callable[[str, Any], Any]) -> None:
        """Register ``handler(client_id, payload) -> ack_result | None``."""
        self._handlers[event] = handler

    async def _reap_dead_clients(self) -> None:
        """Evict clients with no traffic inside the heartbeat timeout.

        Closing the transport makes the client's read loop exit, which runs
        the normal disconnect path — so a silently-dead worker's outstanding
        state is requeued exactly like a clean disconnect's."""
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            cutoff = time.monotonic() - self.heartbeat_timeout
            for client_id, seen in list(self._last_seen.items()):
                endpoint = self._clients.get(client_id)
                if endpoint is not None and seen < cutoff:
                    print(f"[transport] reaping silent client {client_id[:8]} "
                          f"(no traffic for {self.heartbeat_timeout:.0f}s)", file=sys.stderr, flush=True)
                    endpoint.writer.close()

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        client_id = uuid.uuid4().hex
        endpoint = _Endpoint(self._loop, writer, fault_plan=self.fault_plan,
                             telemetry=self.telemetry, role="server")
        self._clients[client_id] = endpoint
        self._last_seen[client_id] = time.monotonic()
        if self.on_connect:
            # executor, not inline: callbacks call emit_to/broadcast, which
            # block on this very loop — running them here would deadlock
            def _safe_connect(cid=client_id):
                try:
                    self.on_connect(cid)
                except Exception as e:
                    print(f"[transport] on_connect error: {e!r}", file=sys.stderr, flush=True)

            await self._loop.run_in_executor(None, _safe_connect)
        async def dispatch(msg: Dict[str, Any]) -> None:
            handler = self._handlers.get(msg.get("event"))
            result = None
            if handler is not None:
                # run in executor: handlers do device work and take locks
                try:
                    result = await self._loop.run_in_executor(
                        None, handler, client_id, msg.get("payload")
                    )
                except Exception as e:
                    # a failing handler must not kill the connection
                    print(f"[transport] handler {msg.get('event')!r} error: {e!r}",
                          file=sys.stderr, flush=True)
                    result = None
            if "msg_id" in msg:
                try:
                    await endpoint._send(
                        {"event": "__ack__", "ack_id": msg["msg_id"], "result": result}
                    )
                except (ConnectionError, TimeoutError):
                    pass  # client closed before the ack; its state is requeued

        try:
            while True:
                frame = await _read_frame(reader)
                msg = decode(frame)
                self._c_received.inc()
                self._last_seen[client_id] = time.monotonic()
                if msg.get("event") == "__ack__":
                    endpoint.handle_ack(msg)
                    continue
                if msg.get("event") == _HB_EVENT:
                    await endpoint._send({"event": _HB_EVENT})  # echo: server liveness
                    hb_payload = msg.get("payload")
                    if hb_payload is not None and self.on_heartbeat is not None:
                        # executor, like every handler: the hook ingests a
                        # telemetry report (locks, file I/O) and must not
                        # stall the read loop
                        def _safe_hb(cid=client_id, p=hb_payload):
                            try:
                                self.on_heartbeat(cid, p)
                            except Exception as e:
                                print(f"[transport] on_heartbeat error: {e!r}",
                                      file=sys.stderr, flush=True)

                        self._loop.run_in_executor(None, _safe_hb)
                    continue
                # fire-and-track: the read loop must stay responsive — a
                # handler that blocks waiting for a peer ack would otherwise
                # deadlock the connection (the ack frame would sit unread)
                self._loop.create_task(dispatch(msg))
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            # ConnectionError, not only its reset: a client dropped while the
            # loop writes to it (the heartbeat echo) fails with BrokenPipeError
            pass
        except FrameCorruptionError as e:
            # a desynced stream cannot be resynchronized: reset the
            # connection (the finally below closes it; the client's
            # reconnect machinery re-establishes a clean session)
            self._c_corrupt_rx.inc()
            print(f"[transport] resetting client {client_id[:8]}: {e}",
                  file=sys.stderr, flush=True)
        except ValueError as e:
            # malformed frame (port scanner, protocol mismatch): drop quietly
            print(f"[transport] closing client {client_id[:8]}: {e}", file=sys.stderr, flush=True)
        finally:
            self._clients.pop(client_id, None)
            self._last_seen.pop(client_id, None)
            writer.close()
            if self.on_disconnect:
                def _safe_disconnect(cid=client_id):
                    try:
                        self.on_disconnect(cid)
                    except Exception as e:
                        print(f"[transport] on_disconnect error: {e!r}", file=sys.stderr, flush=True)

                self._loop.run_in_executor(None, _safe_disconnect)

    # -- sending -----------------------------------------------------------

    def emit_to(self, client_id: str, event: str, payload: Any) -> None:
        endpoint = self._clients.get(client_id)
        if endpoint is None:
            raise KeyError(f"no such client {client_id}")
        asyncio.run_coroutine_threadsafe(
            endpoint.emit_async(event, payload), self._loop
        ).result(ACK_TIMEOUT_S)

    def broadcast(self, event: str, payload: Any) -> None:
        """Send to every connected client (reference ``sockets.emit``)."""
        for client_id in list(self._clients):
            try:
                self.emit_to(client_id, event, payload)
            except Exception:
                pass  # client raced a disconnect; its work will be requeued

    @property
    def num_clients(self) -> int:
        return len(self._clients)

    @property
    def client_ids(self) -> List[str]:
        """Snapshot of currently connected connection ids (per-connection
        uuids — a reconnected client appears under a fresh id)."""
        return list(self._clients)


class ClientTransport:
    """Spoke endpoint: dials the server, receives events, uploads with ack."""

    def __init__(
        self,
        address: str,
        heartbeat_interval: float = HEARTBEAT_INTERVAL_S,
        heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S,
        fault_plan: Optional[FaultPlan] = None,
        telemetry: Optional[Telemetry] = None,
    ):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.heartbeat_interval = heartbeat_interval  # 0 disables heartbeats
        self.heartbeat_timeout = heartbeat_timeout  # 0 disables loss detection
        self.fault_plan = fault_plan
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self._c_received = self.telemetry.counter(
            "transport_frames_received_total", role="client",
            help="frames received and framed off the wire")
        self._c_corrupt_rx = self.telemetry.counter(
            "transport_frames_corrupt_rx_total", role="client",
            help="received frames rejected by checksum/decode")
        self.on_server_lost: Optional[Callable[[], None]] = None
        # fleet telemetry plane: zero-arg callable polled each beat; a
        # non-None return rides the heartbeat as its payload (how
        # inference clients — no upload path — ship telemetry reports)
        self.heartbeat_payload: Optional[Callable[[], Any]] = None
        self._last_server_frame = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._endpoint: Optional[_Endpoint] = None
        self._handlers: Dict[str, Callable[[Any], None]] = {}
        self._connected = threading.Event()
        self._connect_error: Optional[BaseException] = None
        self._stopped = False

    def on(self, event: str, handler: Callable[[Any], None]) -> None:
        self._handlers[event] = handler

    def connect(self, timeout: float = CONNECT_TIMEOUT_S) -> "ClientTransport":
        # reset per attempt: a failed connect must not poison a retry on
        # the same object (the failed attempt's loop thread has exited)
        self._connect_error = None
        self._connected.clear()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        ok = self._connected.wait(timeout)
        if self._connect_error is not None:
            # fail fast with the real error instead of burning the whole
            # timeout; the loop thread has already exited cleanly. Dial
            # failures (refused/unreachable/reset) surface as the typed
            # retryable ConnectionLost; anything else stays loud and fatal.
            err = self._connect_error
            self._thread.join(timeout=1)
            if isinstance(err, (OSError, asyncio.TimeoutError)) and not isinstance(
                err, TransportError
            ):
                raise ConnectionLost(
                    f"could not connect to {self.host}:{self.port}: {err!r}"
                ) from err
            raise err
        if not ok:
            raise ConnectionLost(f"could not connect to {self.host}:{self.port}")
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            reader, writer = await asyncio.open_connection(self.host, self.port)
            loop = self._loop
            # pin THIS connection's endpoint: a second connect() replaces
            # self._endpoint/self._loop, and a heartbeat reading the
            # attribute would bind the new endpoint's write lock to this
            # (abandoned) loop
            endpoint = _Endpoint(loop, writer, fault_plan=self.fault_plan,
                                 telemetry=self.telemetry, role="client")
            self._endpoint = endpoint
            self._last_server_frame = time.monotonic()
            self._connected.set()

            async def heartbeat():
                while True:
                    await asyncio.sleep(self.heartbeat_interval)
                    hb_payload = None
                    if self.heartbeat_payload is not None:
                        # executor: the provider builds a report off-loop
                        # (registry locks); a failing provider degrades to
                        # a plain beat instead of killing liveness
                        try:
                            hb_payload = await loop.run_in_executor(
                                None, self.heartbeat_payload)
                        except Exception as e:
                            print(f"[transport] heartbeat payload error: "
                                  f"{e!r}", file=sys.stderr, flush=True)
                    try:
                        await endpoint.emit_async(_HB_EVENT, hb_payload)
                    except (ConnectionError, RuntimeError):
                        return
                    if (
                        self.heartbeat_timeout > 0
                        and time.monotonic() - self._last_server_frame
                        > self.heartbeat_timeout
                    ):
                        print("[transport] server lost (no frames for "
                              f"{self.heartbeat_timeout:.0f}s)", file=sys.stderr, flush=True)
                        if self.on_server_lost is not None:
                            await loop.run_in_executor(None, self.on_server_lost)
                        writer.close()
                        return

            if self.heartbeat_interval > 0:
                self._loop.create_task(heartbeat())

            async def dispatch(msg):
                handler = self._handlers.get(msg.get("event"))
                if handler is not None:
                    try:
                        await loop.run_in_executor(
                            None, handler, msg.get("payload")
                        )
                    except Exception as e:
                        print(f"[transport] client handler "
                              f"{msg.get('event')!r} error: {e!r}", file=sys.stderr, flush=True)

            try:
                while True:
                    frame = await _read_frame(reader)
                    msg = decode(frame)
                    self._c_received.inc()
                    self._last_server_frame = time.monotonic()
                    if msg.get("event") == "__ack__":
                        endpoint.handle_ack(msg)
                        continue
                    if msg.get("event") == _HB_EVENT:
                        continue  # server's heartbeat echo; timestamp is enough
                    loop.create_task(dispatch(msg))
            except (asyncio.IncompleteReadError, ConnectionError):
                # server went away (EOF, reset or broken pipe) without us
                # calling close()
                if not self._stopped and self.on_server_lost is not None:
                    print("[transport] server connection lost", file=sys.stderr, flush=True)
                    await loop.run_in_executor(None, self.on_server_lost)
            except FrameCorruptionError as e:
                # desynced stream: reset and let the reconnect machinery
                # re-establish a clean session
                self._c_corrupt_rx.inc()
                print(f"[transport] resetting connection: {e}", file=sys.stderr, flush=True)
                if not self._stopped and self.on_server_lost is not None:
                    await self._loop.run_in_executor(None, self.on_server_lost)
            except asyncio.CancelledError:
                pass
            except ValueError as e:
                print(f"[transport] closing connection: {e}", file=sys.stderr, flush=True)
            finally:
                if self._endpoint is not None:
                    # in-flight requests fail fast with a retryable error
                    # instead of waiting out their full ack timeout
                    self._endpoint.fail_pending(
                        ConnectionLost("connection closed with requests in flight"))
                writer.close()

        try:
            self._loop.run_until_complete(main())
        except asyncio.CancelledError:
            # close() cancelled us mid-await (e.g. while the read loop was
            # running the on_server_lost callback): a deliberate teardown,
            # not an error — BaseException, so the clause below misses it
            pass
        except Exception as e:
            if not self._connected.is_set():
                # connection never came up (refused/unreachable): hand the
                # error to the waiting connect() instead of dying unhandled
                # on this thread
                self._connect_error = e
                self._connected.set()
            elif not self._stopped:
                raise  # established-connection failure: keep it loud
        finally:
            # Drain before closing: fail_pending() resolves the in-flight
            # request futures inside main()'s teardown, but the chained
            # concurrent.futures (run_coroutine_threadsafe) only observe
            # that on a later loop iteration — closing immediately would
            # abandon them, and a caller mid-``request()`` would burn its
            # full ack timeout against a dead loop instead of seeing the
            # retryable ConnectionLost now (the fleet router's failover
            # path depends on the prompt signal).
            try:
                pending = asyncio.all_tasks(self._loop)
                for task in pending:
                    task.cancel()
                if pending:
                    self._loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True))
                self._loop.run_until_complete(asyncio.sleep(0))
            except Exception:
                pass
            self._loop.close()

    def request(self, event: str, payload: Any, timeout: float = ACK_TIMEOUT_S) -> Any:
        """Emit with ack (reference ``uploadVars``' 5 s reject timer).

        Raises :class:`AckTimeout` when no ack arrives in ``timeout`` and
        :class:`ConnectionLost` when the connection is (or goes) down —
        both retryable, unlike a codec/protocol error."""
        if self._endpoint is None:
            raise ConnectionLost("not connected")
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._endpoint.request_async(event, payload, timeout), self._loop
            )
        except RuntimeError as e:  # event loop already closed (connection died)
            raise ConnectionLost(f"transport loop closed: {e}") from e
        try:
            return fut.result(timeout + 1.0)
        except (TimeoutError, asyncio.TimeoutError, concurrent.futures.TimeoutError) as e:
            if self._stopped or self._loop is None or self._loop.is_closed():
                # the ack never came because the connection died under us —
                # can't cancel a future on a closed loop; report the truth
                raise ConnectionLost("transport closed while awaiting ack") from e
            fut.cancel()
            raise AckTimeout(f"no ack for {event!r} within {timeout}s") from e
        except ConnectionLost:
            raise
        except (ConnectionError, concurrent.futures.CancelledError,
                asyncio.CancelledError) as e:
            raise ConnectionLost(f"connection lost mid-request: {e!r}") from e

    def emit(self, event: str, payload: Any) -> None:
        if self._endpoint is None:
            raise ConnectionLost("not connected")
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self._endpoint.emit_async(event, payload), self._loop
            )
        except RuntimeError as e:
            raise ConnectionLost(f"transport loop closed: {e}") from e
        fut.result(ACK_TIMEOUT_S)

    def close(self) -> None:
        self._stopped = True  # deliberate close: suppress on_server_lost
        if self._loop is None or self._loop.is_closed():
            return
        loop = self._loop

        def _shutdown():
            for task in asyncio.all_tasks(loop):
                task.cancel()

        try:
            loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            return  # loop closed between the check and the call
        if self._thread is not None:
            self._thread.join(timeout=5)
