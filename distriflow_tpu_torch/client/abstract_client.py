"""Port of ``distriflow_tpu/client/abstract_client.py``: the worker
role over the wire, unchanged in behaviour (download install with delta
apply, upload with ack and retry, reconnect and resync, gradient
compression with error feedback, the ``inflight_window`` pipeline).

PyTorch idiom inside: the worker's model keeps its params on its own
device. A download is deserialized on the host against the wire-layout
template (``models/base.py::params_to_wire``) and installed with one
copy; gradients come back from ``fit`` on the device, are copied to the
host once and put in the wire layout before compression and
serialization, so the wire carries the JAX package's paths and bytes.

The JAX module's description follows.

Abstract client: the DistriWorker role over the wire.

Re-design of the reference ``AbstractClient`` (``src/client/abstract_client.ts``):
connect to a server URL, await the first Download (10 s timeout), keep weights
in sync on every Download broadcast, upload gradients with ack (5 s timeout),
manage client identity, per-version update counts, and the three-level
hyperparameter precedence (local config > server-pushed > defaults,
reference ``federated_client.ts:138-140``).

Client identity: explicit config > persisted identity file (the cookie
equivalent — the reference stores a 1-year ``Distributed-learner-uuid``
cookie, ``src/client/utils.ts:49-64``) > fresh uuid.

Concurrency: the transport handler thread, the pipelined comm thread, and
the background reconnect loop all touch client state. Shared mutable fields
carry ``# guarded-by: <lock>`` annotations, which the JAX package's
``python -m distriflow_tpu.analysis`` enforces over its copy (docs/ANALYSIS.md): ``_download_lock`` serializes
weight installs, ``_comm_cv`` guards the upload-pipeline accounting, and
``_stats_lock`` guards the small cross-thread stats (per-version update
counts, telemetry-report clock), and ``_model_lock`` keeps a weight install
from copying into the parameters while a fit on another thread uses them. ``self.transport`` is deliberately
unguarded: it is swapped atomically by the reconnect loop and callers
capture it once per operation (``transport = self.transport``).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import uuid as uuid_lib
from typing import Any, Callable, Dict, Optional

import numpy as np

from distriflow_tpu_torch.comm.transport import (
    CONNECT_TIMEOUT_S,
    HEARTBEAT_INTERVAL_S,
    HEARTBEAT_TIMEOUT_S,
    AckTimeout,
    ClientTransport,
    ConnectionLost,
    FaultPlan,
)
from distriflow_tpu_torch.models.base import (
    DistributedModel,
    ModelSource,
    fetch_model,
    params_from_wire,
    params_to_wire,
)
from distriflow_tpu_torch.obs.collector import ReportBuilder
from distriflow_tpu_torch.obs.profiler import NOOP_PROFILER
from distriflow_tpu_torch.obs.telemetry import Telemetry, get_telemetry
from distriflow_tpu_torch.utils.config import (
    COMPRESSION_DTYPES,
    DEFAULT_CLIENT_HYPERPARAMS,
    RetryPolicy,
    client_hyperparams,
)
from distriflow_tpu_torch.utils.logging import CallbackRegistry, VerboseLogger
from distriflow_tpu_torch.utils.messages import DownloadMsg, Events, UploadMsg
from distriflow_tpu_torch.utils.serialization import (
    _f32,
    _kind,
    _leaves_with_path,
    cast_tree,
    deserialize_array,
    deserialize_tree,
    quantize_array,
    sanitize_finite,
    serialize_tree,
    topk_array,
    tree_map_with_path,
    tree_wire_nbytes,
)

IDENTITY_FILE = ".distriflow-learner-uuid"  # cookie-equivalent persistence


@dataclasses.dataclass
class DistributedClientConfig:
    """Reference ``DistributedClientConfig`` (``abstract_client.ts:22-28``).

    The retry/reconnect knobs have no reference counterpart — the reference
    client dies on the first ack timeout or dropped websocket. Uploads carry
    a client-generated ``update_id`` so retrying after an ambiguous ack
    timeout is safe (the server dedups), and a lost connection triggers a
    background re-dial loop (``reconnect_retry``) that re-runs the handshake
    and resumes the worker loop.
    """

    client_id: Optional[str] = None
    hyperparams: Optional[Dict[str, Any]] = None
    send_metrics: bool = False
    verbose: Optional[bool] = None
    identity_dir: Optional[str] = None  # where the uuid file lives; None = no persistence
    # reference default is 5 s (abstract_client.ts:13); a first step that
    # builds kernels on the server easily exceeds that, so the knob is explicit
    upload_timeout_s: float = 60.0
    heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S  # 0 disables
    heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S  # server-loss detection
    # upload retry: per-attempt ack timeout stays upload_timeout_s; these
    # delays only pace the re-sends of the SAME UploadMsg/update_id
    upload_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_retries=3, initial_backoff_s=0.1, max_backoff_s=2.0
        )
    )
    reconnect: bool = True  # auto re-dial on server loss
    reconnect_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_retries=8, initial_backoff_s=0.2, max_backoff_s=5.0
        )
    )
    # fault injection (tests / chaos drills): consulted by the client's
    # transport at every frame boundary
    fault_plan: Optional[FaultPlan] = None
    # telemetry spine (see distriflow_tpu_torch.obs): None uses the process-global
    # instance; loopback tests share one Telemetry with the server so the
    # upload/apply spans of a trace land in the same tracer
    telemetry: Optional[Telemetry] = None


def resolve_client_id(config: DistributedClientConfig) -> str:
    """config > identity file > fresh uuid (reference ``abstract_client.ts:66-73``)."""
    if config.client_id:
        return config.client_id
    if config.identity_dir is not None:
        path = os.path.join(config.identity_dir, IDENTITY_FILE)
        if os.path.exists(path):
            with open(path) as f:
                stored = f.read().strip()
            if stored:
                return stored
        fresh = uuid_lib.uuid4().hex
        os.makedirs(config.identity_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(fresh)
        return fresh
    return uuid_lib.uuid4().hex


class AbstractClient:
    #: class-level default so protocol probes (test stubs that skip
    #: ``__init__``) still serialize/upload; real instances rebind to
    #: their telemetry's profiler in ``__init__``
    _prof = NOOP_PROFILER

    def __init__(
        self,
        server_address: str,
        model: ModelSource,
        config: Optional[DistributedClientConfig] = None,
    ):
        self.server_address = server_address
        self.model: DistributedModel = fetch_model(model)
        self.config = config or DistributedClientConfig()
        if self.config.hyperparams:
            # fail fast on typo'd keys/values (strict-key override + validate,
            # reference utils.ts:206-234) instead of erroring mid-upload on a
            # transport handler thread where the exception is only printed
            client_hyperparams(self.config.hyperparams)
        self.client_id = resolve_client_id(self.config)
        self.logger = VerboseLogger(f"{type(self).__name__}[{self.client_id[:8]}]",
                                    self.config.verbose)
        self.callbacks = CallbackRegistry("download", "new_version", "upload", "reconnect")
        self.transport: Optional[ClientTransport] = None
        self.msg: Optional[DownloadMsg] = None  # last Download
        self.version_update_counts: Dict[str, int] = {}  # reference :36,112-122  # guarded-by: _stats_lock
        # guards the cross-thread stats below: a pipelined upload (comm
        # thread) and a serial upload (handler thread) may finish
        # concurrently, and the reconnect loop resets the report clock
        self._stats_lock = threading.Lock()
        self._first_download = threading.Event()
        self._download_lock = threading.Lock()
        # the model's parameters live in place on its device: an install
        # copies into the very tensors a fit's autograd graph has saved, so
        # installs and fits/evaluates (on different handler threads when
        # the server dispatches ahead) must not overlap. JAX rebinds an
        # immutable pytree instead and needs no such lock.
        self._model_lock = threading.Lock()
        # reconnect machinery: _transport_ready is set while a dialed
        # transport is (believed) usable; upload retries park on it instead
        # of hammering a dead connection. _resumed is set by the first
        # Download/trainingComplete after a dial, telling the reconnect loop
        # the handshake completed. connection_failed latches when the
        # re-dial budget is exhausted (worker loops check it and bail).
        self._transport_ready = threading.Event()
        self._resumed = threading.Event()
        self._reconnect_lock = threading.Lock()
        self._disposed = False
        self.reconnects = 0
        self.connection_failed = threading.Event()
        self.telemetry = (
            self.config.telemetry
            if self.config.telemetry is not None
            else get_telemetry()
        )
        self._c_reconnects = self.telemetry.counter(
            "client_reconnects_total",
            help="reconnect attempts after a dropped server connection")
        self._c_uploads = self.telemetry.counter(
            "client_uploads_total", help="variable uploads sent to the server")
        self._c_retries = self.telemetry.counter(
            "client_upload_retries_total",
            help="upload attempts retried after a transport failure")
        # wire accounting (see docs/OBSERVABILITY.md comm_* table)
        self._c_up_bytes = self.telemetry.counter(
            "comm_up_bytes_total", role="client",
            help="payload bytes sent upstream")
        self._c_down_bytes = self.telemetry.counter(
            "comm_down_bytes_total", role="client",
            help="payload bytes received downstream")
        self._c_up_sparse = self.telemetry.counter(
            "comm_uploads_sparse_total", role="client",
            help="uploads shipped sparse (top-k compressed)")
        self._c_up_dense = self.telemetry.counter(
            "comm_uploads_dense_total", role="client",
            help="uploads shipped dense (compression bypassed)")
        self._c_down_delta = self.telemetry.counter(
            "comm_broadcasts_delta_total", role="client",
            help="delta broadcasts received")
        self._c_down_full = self.telemetry.counter(
            "comm_broadcasts_full_total", role="client",
            help="full-model broadcasts received")
        self._c_resyncs = self.telemetry.counter(
            "comm_resyncs_total", role="client",
            help="full-state resyncs after a version gap")
        self._g_residual = self.telemetry.gauge(
            "comm_residual_norm",
            help="norm of the error-feedback residual carried locally")
        # continuous phase profiler (docs/OBSERVABILITY.md §5): the
        # client step decomposes into fit / ef_compress / serialize /
        # submit / ack_wait; shared no-op handles when telemetry is off
        self._prof = self.telemetry.profiler("client")
        # fleet telemetry plane (docs/OBSERVABILITY.md §10): a report of
        # this process's metrics piggybacks on upload metadata every
        # telemetry_report_interval_s; the process sampler adds host
        # RSS/CPU gauges to what ships (idempotent on shared Telemetry)
        self._report_builder = ReportBuilder(self.telemetry, self.client_id)
        self._last_report_t = 0.0  # guarded-by: _stats_lock
        self.telemetry.register_process_sampler()
        # int8/topk gradient compression: per-leaf compression residual
        # carried into the next upload (error feedback); keyed by tree path
        self._quant_error: Optional[Dict[str, Any]] = None
        # version of the last *installed* weights — the base a delta
        # broadcast must name for us to be able to apply it
        self._installed_version: Optional[str] = None
        # double-buffered upload pipeline (hyperparam ``inflight_window``):
        # a single lazily-started comm thread carries EF-compress ->
        # serialize -> submit -> ack while the handler thread fits the next
        # batch. ONE thread, processing in enqueue order, is what keeps the
        # error-feedback residual handoff sequentially consistent — the
        # residual a gradient picks up is exactly the residual its
        # predecessor left. Depth is bounded by a slot semaphore
        # (window - 1 uploads in flight beyond the fit in progress).
        self._comm_q: Optional["queue.Queue[Any]"] = None
        self._comm_thread: Optional[threading.Thread] = None
        self._comm_slots: Optional[threading.Semaphore] = None
        self._comm_pending = 0  # guarded-by: _comm_cv
        self._comm_cv = threading.Condition()
        self._comm_error: Optional[BaseException] = None

    # -- observability -----------------------------------------------------

    def on_new_version(self, fn: Callable[..., Any]) -> None:
        self.callbacks.register("new_version", fn)

    def on_reconnect(self, fn: Callable[..., Any]) -> None:
        """``fn(reconnects)`` fires after a successful re-dial + handshake."""
        self.callbacks.register("reconnect", fn)

    def log(self, *args: Any) -> None:
        self.logger.log(*args)

    def time(self, msg: str):
        return self.logger.time(msg)

    # -- lifecycle ---------------------------------------------------------

    def setup(self, timeout: float = CONNECT_TIMEOUT_S) -> None:
        """Connect and await the first Download (reference ``:166-173``)."""
        self.model.setup()
        self._dial(timeout)
        if not self._first_download.wait(timeout):
            raise AckTimeout(f"no initial Download within {timeout}s")

    def _dial(self, timeout: float = CONNECT_TIMEOUT_S) -> None:
        """Build + connect a fresh transport and wire up all handlers.

        Used by both the initial :meth:`setup` and the background reconnect
        loop — reconnection re-runs the full handshake (the server treats a
        re-dialed client as a fresh connection and pushes a new Download).
        """
        transport = ClientTransport(
            self.server_address,
            heartbeat_interval=self.config.heartbeat_interval_s,
            heartbeat_timeout=self.config.heartbeat_timeout_s,
            fault_plan=self.config.fault_plan,
            telemetry=self.telemetry,
        )
        transport.on(Events.Download.value, self._on_download)
        transport.on("trainingComplete", self._on_training_complete)
        transport.on_server_lost = self._handle_server_lost
        transport.connect(timeout)
        self.transport = transport
        self._transport_ready.set()

    def _handle_server_lost(self) -> None:
        """Transport-thread callback: connection dropped or server silent."""
        self._transport_ready.clear()
        if self._disposed or not self.config.reconnect:
            self.connection_failed.set()
            return
        threading.Thread(
            target=self._reconnect_loop, name="client-reconnect", daemon=True
        ).start()

    def _reconnect_loop(self) -> None:
        """Re-dial with exponential backoff + jitter until the handshake
        completes (a fresh Download — or trainingComplete — arrives) or the
        retry budget runs out. At most one loop runs at a time; a second
        ``on_server_lost`` while we're already reconnecting is a no-op."""
        if not self._reconnect_lock.acquire(blocking=False):
            return
        try:
            old, self.transport = self.transport, None
            if old is not None:
                old.close()
            policy = self.config.reconnect_retry.validate()
            for attempt, delay in enumerate(policy.delays(), start=1):
                if self._disposed:
                    return
                time.sleep(delay)
                self._resumed.clear()
                try:
                    self._dial()
                except Exception as exc:  # noqa: BLE001 - retry any dial failure
                    self.log(f"reconnect attempt {attempt} failed: {exc!r}")
                    continue
                # handshake: the server pushes a Download (or, if the run
                # finished while we were gone, a trainingComplete) on connect
                if not self._resumed.wait(CONNECT_TIMEOUT_S):
                    self.log(f"reconnect attempt {attempt}: no Download after dial")
                    self.transport.close()
                    self._transport_ready.clear()
                    continue
                self.reconnects += 1
                self._c_reconnects.inc()
                # the server may be fresh (restart) or missed in-flight
                # deltas: next telemetry report is a full snapshot, now
                self._report_builder.reset()
                with self._stats_lock:
                    self._last_report_t = 0.0
                self.log(f"reconnected to {self.server_address} "
                         f"(attempt {attempt}, total reconnects {self.reconnects})")
                self.callbacks.fire("reconnect", self.reconnects)
                return
            self.log("reconnect budget exhausted; giving up")
            self.connection_failed.set()
        finally:
            self._reconnect_lock.release()

    def dispose(self) -> None:
        self._disposed = True
        self._stop_comm_thread()
        self._transport_ready.clear()
        if self.transport is not None:
            self.transport.close()

    def abort(self) -> None:
        """Abrupt kill (chaos/soak churn): no goodbye, no upload drain —
        the in-process stand-in for a worker crash. The connection just
        dies; the server learns via EOF (or heartbeat timeout) and
        requeues the outstanding window. Unlike :meth:`dispose`, anything
        riding the upload pipeline is abandoned mid-flight — which is
        exactly the case the server's lease/requeue/dedup machinery must
        absorb."""
        self._disposed = True  # suppresses on_server_lost -> reconnect
        self._transport_ready.clear()
        transport = self.transport
        if transport is not None:
            transport.close()
        # reap the comm thread WITHOUT draining: queued uploads fail fast
        # against the closed transport (the loop parks them as comm
        # errors), and the thread exits on the sentinel. Read and clear it
        # under _comm_cv, which _comm_acquire_slot holds across create and
        # start, so the thread joined here has always been started (the
        # JAX reference reads it unlocked and can join an unstarted thread)
        with self._comm_cv:
            thread, self._comm_thread = self._comm_thread, None
            comm_q = self._comm_q
        if thread is not None:
            comm_q.put(None)
            thread.join(timeout=5.0)

    # -- upload pipeline (inflight_window > 1) -------------------------------

    def inflight_window(self) -> int:
        """Effective upload-pipeline depth (hyperparam ``inflight_window``,
        three-level precedence like every other knob). 1 = serial."""
        try:
            return max(1, int(self.hyperparam("inflight_window")))
        except (TypeError, ValueError):
            return 1

    def _comm_acquire_slot(self) -> bool:
        """Backpressure: block until the upload window has room. Starts the
        comm thread on first use. MUST be called with no locks held — the
        comm thread takes client locks to publish results.

        Returns False (holding no slot) once the client is disposed. The
        wait is bounded and re-checked: ``abort()`` reaps the comm thread
        WITHOUT draining, so a permit held by an abandoned upload is never
        released — an unbounded ``acquire()`` here would strand the
        transport's dispatch thread (non-daemon: the interpreter would
        then hang at exit joining it) on a semaphore nobody will post."""
        while True:
            if self._disposed:
                return False
            if self._comm_thread is None:
                with self._comm_cv:
                    if self._disposed:  # abort() ran while we waited
                        return False
                    if self._comm_thread is None:
                        window = self.inflight_window()
                        self._comm_q = queue.Queue()
                        self._comm_slots = threading.Semaphore(
                            max(1, window - 1))
                        self._comm_thread = threading.Thread(
                            target=self._comm_loop,
                            name=f"client-comm-{self.client_id[:8]}",
                            daemon=True)
                        self._comm_thread.start()
            if self._comm_slots.acquire(timeout=0.5):
                return True

    def _comm_release_slot(self) -> None:
        self._comm_slots.release()

    def _comm_put(self, task: Callable[[], Any]) -> None:
        """Enqueue one comm task (slot already held). Safe to call while
        holding client locks: the put never blocks."""
        with self._comm_cv:
            self._comm_pending += 1
        self._comm_q.put(task)

    def _comm_loop(self) -> None:
        while True:
            task = self._comm_q.get()
            if task is None:
                return
            t0 = time.perf_counter()
            try:
                task()
            except BaseException as e:  # noqa: BLE001 - park, don't kill the pipe
                # a terminally failed upload is recoverable: the server's
                # lease expires, the batch redelivers, and the cached
                # message re-uploads under the same update_id
                self._comm_error = e
                self.log(f"pipelined upload failed: {e!r}")
            finally:
                # the comm thread runs concurrently with the handler
                # thread's steps: its time is overlap, never step busy
                self._prof.record_overlap(
                    None, (time.perf_counter() - t0) * 1e3)
                self._comm_slots.release()
                with self._comm_cv:
                    self._comm_pending -= 1
                    self._comm_cv.notify_all()

    def drain_uploads(self, timeout: float = 30.0) -> bool:
        """Block until every in-flight pipelined upload has completed (or
        failed); True when the window is empty. No-op when serial."""
        with self._comm_cv:
            return self._comm_cv.wait_for(
                # wait_for evaluates the predicate WITH the condition held —
                # safe, but beyond the analyzer's lexical proof
                lambda: self._comm_pending == 0, timeout)  # dfcheck: ignore[lock-discipline]

    def _stop_comm_thread(self) -> None:
        thread = self._comm_thread
        if thread is None:
            return
        self.drain_uploads(timeout=5.0)
        self._comm_q.put(None)
        thread.join(timeout=5.0)
        self._comm_thread = None

    # -- download handling --------------------------------------------------

    def _on_download(self, payload: Any) -> None:
        msg = DownloadMsg.from_wire(payload)
        self._c_down_bytes.inc(tree_wire_nbytes(msg.model.vars))
        if msg.model.delta_base is not None:
            self._c_down_delta.inc()
        else:
            self._c_down_full.inc()
        with self._download_lock:
            if msg.trace_id:
                # join the dispatch's trace so the assembler can place the
                # install leg on the round's critical path
                with self.telemetry.span(
                    "install", trace_id=msg.trace_id, parent_id=msg.span_id,
                    client_id=self.client_id, model_version=msg.model.version,
                    delta=msg.model.delta_base is not None,
                ) as ispan:
                    installed = self.set_params_from(msg)
                    ispan.set(installed=installed)
            else:
                installed = self.set_params_from(msg)
            if installed:
                self.msg = msg
        if not installed:
            # delta against a base we don't hold (dropped broadcast, stale
            # server-side ledger): discard it and ask for a full sync. The
            # handshake events deliberately stay unset — only an installed
            # Download resumes the worker loop.
            self._c_resyncs.inc()
            self.log(
                f"delta broadcast base {msg.model.delta_base!r} != installed "
                f"{self._installed_version!r}; requesting full resync"
            )
            transport = self.transport
            if transport is not None:
                try:
                    transport.emit(Events.Resync.value, {"client_id": self.client_id})
                except Exception as exc:  # noqa: BLE001 - reconnect loop owns recovery
                    self.log(f"resync request failed: {exc!r}")
            return
        first = not self._first_download.is_set()
        self._first_download.set()
        self._resumed.set()  # reconnect handshake complete
        self.callbacks.fire("download", msg)
        self.callbacks.fire("new_version", msg.model.version)
        self.handle_download(msg, first=first)

    def _on_training_complete(self, payload: Any) -> None:
        # also counts as a completed handshake: a client reconnecting after
        # the dataset ran dry gets only trainingComplete, never a Download
        self._resumed.set()
        self.handle_training_complete()

    def set_params_from(self, msg: DownloadMsg) -> bool:
        """Deserialize and install weights (reference ``setVars`` in tidy, ``:160-164``).

        Weights may arrive 16-bit (server ``weight_compression``);
        ``deserialize_tree`` lands every leaf back on the local model's own
        param dtype, so the model never silently becomes half precision.

        A *delta* broadcast (``msg.model.delta_base`` set) carries per-leaf
        ``new - base`` for float leaves (full values for non-float leaves)
        against the params of version ``delta_base``. It only installs when
        our installed version matches that base; returns False otherwise so
        the caller can request a full resync instead of applying a delta to
        the wrong foundation.

        Which leaves are deltas is read from each leaf's dtype on the wire,
        not from the local model's: the server ships ``new - base`` only for
        its own float leaves (numpy kind ``"f"``, so f32 or, under
        ``weight_compression="float16"``, f16), and every other leaf whole.
        A bfloat16 server (or ``weight_compression="bfloat16"``) thus
        replaces an f32 worker's weights instead of adding to them. The JAX
        client decides from its own param dtype and adds them."""
        m = msg.model
        if m.delta_base is not None and m.delta_base != self._installed_version:
            return False
        with self._model_lock:
            # the host copy of the installed params, in the wire layout
            template = params_to_wire(self.model, self.model.get_params())
            if m.delta_base is not None:
                delta = dict(_leaves_with_path(deserialize_tree(m.vars, template)))

                def apply_delta(path, t):
                    d = delta[path]
                    return t + d if _kind(m.vars[path].dtype) == "f" else d

                new = tree_map_with_path(apply_delta, template)
            else:
                new = deserialize_tree(m.vars, template)
            self.model.set_params(params_from_wire(self.model, new))
        self._installed_version = m.version
        return True

    # -- upload -------------------------------------------------------------

    def upload(self, msg: UploadMsg, timeout: Optional[float] = None) -> Any:
        """Emit with ack + timeout (reference ``uploadVars``, ``:148-158``),
        retrying on ack timeout / connection loss.

        Retries are safe because every upload carries a stable ``update_id``
        (stamped here if the caller didn't): an ack timeout is ambiguous —
        the server may or may not have applied the gradient — so we resend
        the *same* message and let the server's dedup cache make the second
        delivery a no-op. Between attempts we park on ``_transport_ready``
        so a retry rides the reconnected transport instead of the dead one.
        Raises the last :class:`AckTimeout` / :class:`ConnectionLost` when
        the retry budget is exhausted.
        """
        if timeout is None:
            timeout = self.config.upload_timeout_s
        if msg.update_id is None:
            msg.update_id = uuid_lib.uuid4().hex
        self._c_uploads.inc()
        if msg.gradients is not None:
            self._c_up_bytes.inc(tree_wire_nbytes(msg.gradients.vars))
            if any(s.indices is not None for s in msg.gradients.vars.values()):
                self._c_up_sparse.inc()
            else:
                self._c_up_dense.inc()
        reconnects_at_start = self.reconnects
        transport_at_start = self.transport
        # ONE span covers every attempt: retries resend the same wire bytes
        # (same update_id, same trace_id), so the span's trace is the trace
        # every duplicate delivery and the eventual server apply land in. If
        # the caller pre-stamped a trace_id (e.g. from the dispatch that
        # produced this update), the span joins it; otherwise it starts one.
        with self.telemetry.span(
            "upload", trace_id=msg.trace_id,
            client_id=self.client_id, update_id=msg.update_id,
        ) as span:
            msg.trace_id = span.trace_id or msg.trace_id
            msg.span_id = span.span_id or msg.span_id
            if msg.gradients is not None:
                span.set(model_version=msg.gradients.version)
            if msg.report is None:
                # attach BEFORE serialization so retries resend the same
                # report bytes (the collector's seq gating dedups them)
                msg.report = self._maybe_build_report()
            t_ser = time.perf_counter()
            with self._prof.phase("serialize"):
                wire = msg.to_wire()
            # sub-durations the trace assembler carves the span with:
            # serialize_ms heads the span, ack_wait_ms sums the in-flight
            # request->ack waits across attempts (backoff sleeps excluded)
            span.set(serialize_ms=(time.perf_counter() - t_ser) * 1e3)
            ack_wait_ms = 0.0
            policy = self.config.upload_retry.validate()
            last_exc: Optional[Exception] = None
            delays = [None, *policy.delays()]  # first attempt is immediate
            attempts = 0
            try:
                # `submit` bounds the whole retry loop; `ack_wait` nests
                # inside it around each request->ack round trip (the step
                # attribution counts only the outermost, so the pair does
                # not double-count)
                with self._prof.phase("submit"):
                    for attempt, delay in enumerate(delays):
                        if self._disposed:
                            raise last_exc or ConnectionLost("client disposed")
                        attempts = attempt + 1
                        if delay is not None:
                            self._c_retries.inc()
                            time.sleep(delay)
                            # if a reconnect is in flight, wait (bounded) for
                            # the fresh transport instead of burning the
                            # attempt on a dead one
                            self._transport_ready.wait(timeout)
                        transport = self.transport
                        if transport is None:
                            last_exc = ConnectionLost("not connected")
                            continue
                        t_ack = time.perf_counter()
                        try:
                            with self._prof.phase("ack_wait"):
                                result = transport.request(
                                    Events.Upload.value, wire, timeout)
                            ack_wait_ms += (time.perf_counter() - t_ack) * 1e3
                            break
                        except (AckTimeout, ConnectionLost) as exc:
                            ack_wait_ms += (time.perf_counter() - t_ack) * 1e3
                            last_exc = exc
                            self.log(
                                f"upload attempt {attempt + 1}/{len(delays)} "
                                f"failed ({type(exc).__name__}: {exc}); "
                                f"update_id={msg.update_id}"
                            )
                    else:
                        assert last_exc is not None
                        raise last_exc
            finally:
                # EVERY exit — success, exhausted retries, dispose, abort —
                # records how many reconnects the span straddled, so chaos
                # reconciliation can find the upload that crossed the reset
                # even when that particular call errored out and the retry
                # landed via a redelivered batch on the same trace
                spanned = self.reconnects - reconnects_at_start
                current = self.transport
                if (spanned == 0 and current is not None
                        and current is not transport_at_start):
                    # the ack beat the reconnect loop's counter bump: the
                    # swap of the transport object is the ground truth that
                    # a reconnect happened inside this span
                    spanned = 1
                span.set(attempts=attempts, reconnects_spanned=spanned,
                         ack_wait_ms=ack_wait_ms)
        version = msg.gradients.version if msg.gradients is not None else None
        if version is not None:
            # read-modify-write shared with the comm thread when uploads are
            # pipelined: without the lock two concurrent acks can lose a count
            with self._stats_lock:
                self.version_update_counts[version] = (
                    self.version_update_counts.get(version, 0) + 1
                )
        self.callbacks.fire("upload", msg, result)
        return result

    def _maybe_build_report(self) -> Optional[Dict[str, Any]]:
        """A telemetry report when the interval has elapsed, else None.
        Interval 0 (or disabled telemetry) turns shipping off entirely."""
        builder = getattr(self, "_report_builder", None)
        if builder is None or not self.telemetry.enabled:
            return None  # protocol probes that skip __init__
        try:
            interval = float(self.hyperparam("telemetry_report_interval_s"))
        except (TypeError, ValueError):
            return None
        if interval <= 0:
            return None
        now = time.monotonic()
        # check-and-advance under the lock: two uploads racing the interval
        # boundary must not both win and ship two full report builds
        with self._stats_lock:
            if now - self._last_report_t < interval:
                return None
            self._last_report_t = now
        return builder.build()

    # -- hyperparameters -----------------------------------------------------

    def hyperparam(self, name: str) -> Any:
        """local > server-pushed > default (reference ``federated_client.ts:138-140``)."""
        local = self.config.hyperparams or {}
        if name in local and local[name] is not None:
            return local[name]
        pushed = (self.msg.hyperparams if self.msg is not None else {}) or {}
        if name in pushed and pushed[name] is not None:
            return pushed[name]
        return getattr(DEFAULT_CLIENT_HYPERPARAMS, name)

    def compress_grads(self, grads: Any) -> Any:
        """Cast gradients per the ``gradient_compression`` hyperparameter
        before serialization (halves upload bytes at 16-bit; the server's
        aggregation accumulates in float32 regardless). int8 goes through
        :meth:`serialize_grads` (it needs per-leaf scales on the wire)."""
        name = str(self.hyperparam("gradient_compression"))
        if name in ("none", "int8", "topk", "topk_int8"):
            return grads
        if name not in COMPRESSION_DTYPES:
            raise ValueError(
                f"gradient_compression must be one of {COMPRESSION_DTYPES}, got {name!r}"
            )
        return cast_tree(grads, name)

    def serialize_grads(self, grads: Any) -> Any:
        """Gradients -> {path: SerializedArray} for an UploadMsg, applying
        ``gradient_compression``.

        ``"int8"`` uses symmetric per-leaf quantization (absmax/127 scale on
        the wire — 4x fewer bytes than float32) with **error feedback**: the
        quantization residual ``g - dequant(q(g))`` is remembered and added
        to the next upload, so the error accumulates into later updates
        instead of being lost (the standard convergence fix for quantized
        gradient push; over time the sum of dequantized uploads tracks the
        sum of true gradients).

        ``"topk"``/``"topk_int8"`` ship only the top-|k| largest-magnitude
        entries per leaf (``k = topk_fraction`` of the leaf size) as a
        sparse :class:`SerializedArray` — indices + values, int8-quantized
        values for ``topk_int8`` — with the same error feedback: the entire
        un-sent mass (dropped entries + quantization error of the kept
        ones) becomes the next residual, so nothing is lost, only delayed
        (Deep Gradient Compression, Lin et al. 2018).

        ``grads`` are in the model's own layout (``fit``'s result, on its
        device); they are copied to the host in the wire layout first."""
        grads = params_to_wire(self.model, grads)
        name = str(self.hyperparam("gradient_compression"))
        if name not in ("int8", "topk", "topk_int8"):
            return serialize_tree(self.compress_grads(grads))
        topk_fraction = (
            float(self.hyperparam("topk_fraction")) if name != "int8" else None
        )
        flat = _leaves_with_path(grads)
        if self._quant_error is None:
            self._quant_error = {}
        out = {}
        residual_sq = 0.0
        with self._prof.phase("ef_compress"):
            for key, leaf in flat:
                # sanitize BEFORE the error-feedback arithmetic: an inf/nan
                # gradient entry would otherwise land in the residual and
                # poison every future upload of this leaf
                g = sanitize_finite(_f32(leaf))
                g = g + self._quant_error.get(key, 0.0)  # carry prior residual
                if name == "int8":
                    sa = quantize_array(g)
                else:
                    sa = topk_array(g, topk_fraction,
                                    quantize=(name == "topk_int8"))
                residual = g - deserialize_array(sa)
                self._quant_error[key] = residual
                residual_sq += float(np.vdot(residual, residual))
                out[key] = sa
        gauge = getattr(self, "_g_residual", None)
        if gauge is not None:
            gauge.set(float(np.sqrt(residual_sq)))
        return out

    # -- subclass hooks -------------------------------------------------------

    def handle_download(self, msg: DownloadMsg, first: bool) -> None:
        pass

    def handle_training_complete(self) -> None:
        pass
