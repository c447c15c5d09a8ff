"""Port of ``distriflow_tpu/server/abstract_server.py``: the shared
mechanics of the two wire-training servers, unchanged in behaviour.

PyTorch idiom inside: the canonical model stays on its own device (the
server's card); every download serializes the host copy of its params in
the wire layout (``models/base.py::params_to_wire``: flax's tree for the
zoo and MobileNet specs, so the wire carries the JAX package's paths and
bytes), and uploads are deserialized on the host and reach the device
once, in the model's ``update``.

The JAX module's description follows.

Abstract server: shared orchestration for the two wire-serving modes.

Re-design of the reference ``AbstractServer`` (``src/server/abstract_server.ts``):
holds the server model, the transport, client/update counters, the update
buffer, the ``updating`` re-entrancy flag, ``compute_download_msg`` (weights +
version + server-pushed client hyperparams), ``on_new_version``/``on_upload``
callback registries, and log/time utilities.

These wire-serving servers exist for the *multi-process* deployments
(federated clients holding their own data; cross-host async coordination).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from distriflow_tpu_torch.models.base import DistributedModel, params_to_wire
from distriflow_tpu_torch.comm.transport import (
    HEARTBEAT_INTERVAL_S,
    HEARTBEAT_TIMEOUT_S,
    FaultPlan,
    ServerTransport,
)
from distriflow_tpu_torch.server.models import (
    DistributedServerCheckpointedModel,
    DistributedServerModel,
    is_server_model,
)
from distriflow_tpu_torch.analysis.witness import ordered_lock
from distriflow_tpu_torch.server.quarantine import GradientGate
from distriflow_tpu_torch.utils.config import (
    ClientHyperparams,
    QuarantinePolicy,
    ServerHyperparams,
    asdict,
    client_hyperparams,
    server_hyperparams,
)
from distriflow_tpu_torch.obs.collector import TelemetryCollector
from distriflow_tpu_torch.obs.health import FleetTable
from distriflow_tpu_torch.obs.telemetry import Telemetry, get_telemetry
from distriflow_tpu_torch.utils.logging import CallbackRegistry, VerboseLogger
from distriflow_tpu_torch.utils.messages import DownloadMsg, Events, ModelMsg, UploadMsg
from distriflow_tpu_torch.utils.serialization import (
    SerializedArray,
    _f32,
    _is_float,
    cast_tree,
    serialize_tree,
    to_numpy,
    tree_map2,
    tree_wire_nbytes,
)

DEFAULT_SAVE_DIR = "./saved-models"  # reference federated_server.ts:37-43


@dataclasses.dataclass
class DistributedServerConfig:
    """Reference ``DistributedServerConfig`` (``abstract_server.ts:24-31``)."""

    client_hyperparams: Optional[Dict[str, Any]] = None
    server_hyperparams: Optional[Dict[str, Any]] = None
    save_dir: str = DEFAULT_SAVE_DIR
    # retention: the reference keeps one checkpoint dir per update forever
    # (server/models.ts:132-138); None preserves that, N keeps the newest N
    max_checkpoints: Optional[int] = None
    verbose: Optional[bool] = None
    host: str = "127.0.0.1"
    port: int = 0
    # failure detection (beyond the reference; SURVEY.md §5): evict clients
    # silent for heartbeat_timeout_s, requeueing their outstanding work
    heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S
    heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S  # 0 disables
    # idempotent uploads: how many applied update_ids the server remembers
    # for duplicate suppression; sized >> the number of uploads any client
    # fleet can have in flight during one ack-timeout window
    dedup_cache_size: int = 1024
    # straggler mitigation (async mode): seconds a dispatched batch is
    # leased to its client before the server speculatively re-dispatches it
    # to a parked client (backup-worker execution, Chen et al. 2016).
    # First-wins arbitration at upload keeps the apply at-most-once even
    # when the straggler eventually answers. 0 disables leases.
    batch_lease_s: float = 0.0
    # gradient quarantine (finiteness + norm-outlier gate before every
    # apply, payload dumps under save_dir/quarantine/, post-apply rollback
    # guard); None uses the default QuarantinePolicy — pass
    # QuarantinePolicy(enabled=False) to switch the gate off entirely
    quarantine: Optional[QuarantinePolicy] = None
    # apply pipeline: uploads are decoded on the transport's handler
    # threads, then handed to ONE bounded-queue apply worker — so the
    # deserialization of update N+1 overlaps the apply of update N, and a
    # full queue backpressures the transport (the handler blocks, acks
    # slow down, clients stop flooding). 0 applies inline on the handler
    # thread (pre-pipeline behavior). The ack still carries the apply
    # verdict either way — the handler waits on the queued apply's future.
    apply_queue_depth: int = 8
    # fault injection (tests / chaos drills): consulted by the server's
    # per-client endpoints at every frame boundary
    fault_plan: Optional[FaultPlan] = None
    # telemetry spine (see distriflow_tpu_torch.obs): None uses the process-global
    # instance; tests/doctor pass one shared Telemetry to both endpoints so
    # cross-endpoint traces land in a single tracer
    telemetry: Optional[Telemetry] = None
    # time-resolved telemetry (docs/OBSERVABILITY.md §12): > 0 starts the
    # telemetry's background timeline sampler at this period for the life
    # of the server (samples + events persist to save_dir/timeline.jsonl);
    # 0 leaves the timeline unstarted
    timeline_interval_s: float = 0.0


class AbstractServer:
    """Shared mechanics of FederatedServer/AsynchronousSGDServer."""

    #: subclass hook: how config.server_hyperparams becomes ServerHyperparams
    #: (the async server swaps in its tolerant staleness default)
    _hyperparams_factory = staticmethod(server_hyperparams)

    def __init__(
        self,
        model: DistributedModel | DistributedServerModel,
        config: Optional[DistributedServerConfig] = None,
        transport: Optional[ServerTransport] = None,
    ):
        self.config = config or DistributedServerConfig()
        # wrap bare models into a checkpointed server model under save_dir
        # (reference federated_server.ts:31-43 auto-wrap)
        if is_server_model(model):
            self.model = model
        else:
            self.model = DistributedServerCheckpointedModel(
                model, self.config.save_dir, self.config.max_checkpoints
            )
        # the model inside the server wrapper: its spec names the wire
        # layout (models/base.py::params_to_wire)
        self._wire_model = getattr(self.model, "model", self.model)
        self.client_hyperparams: ClientHyperparams = client_hyperparams(
            self.config.client_hyperparams
        )
        self.hyperparams: ServerHyperparams = self._hyperparams_factory(
            self.config.server_hyperparams
        )
        self.telemetry = (
            self.config.telemetry
            if self.config.telemetry is not None
            else get_telemetry()
        )
        self.transport = transport or ServerTransport(
            self.config.host,
            self.config.port,
            heartbeat_interval=self.config.heartbeat_interval_s,
            heartbeat_timeout=self.config.heartbeat_timeout_s,
            fault_plan=self.config.fault_plan,
            telemetry=self.telemetry,
        )
        # cached handles: per-event cost is one attribute bump
        self._g_clients = self.telemetry.gauge(
            "server_connected_clients", help="currently connected clients")
        self._g_version = self.telemetry.gauge(
            "server_model_version", help="current global model version")
        self._c_uploads = self.telemetry.counter(
            "server_uploads_total", help="gradient uploads received")
        self._c_dedup = self.telemetry.counter(
            "server_dedup_hits_total",
            help="duplicate uploads suppressed by the dedup cache")
        self._c_recoveries = self.telemetry.counter(
            "server_recoveries_total",
            help="setups resumed from a checkpoint manifest")
        # wire accounting (see docs/OBSERVABILITY.md comm_* table)
        self._c_up_bytes = self.telemetry.counter(
            "comm_up_bytes_total", role="server",
            help="upload payload bytes, by role")
        self._c_down_bytes = self.telemetry.counter(
            "comm_down_bytes_total", role="server",
            help="download payload bytes, by role")
        self._c_up_sparse = self.telemetry.counter(
            "comm_uploads_sparse_total", role="server",
            help="sparse (top-k) uploads, by role")
        self._c_up_dense = self.telemetry.counter(
            "comm_uploads_dense_total", role="server",
            help="dense uploads, by role")
        self._c_down_delta = self.telemetry.counter(
            "comm_broadcasts_delta_total", role="server",
            help="delta-encoded weight broadcasts, by role")
        self._c_down_full = self.telemetry.counter(
            "comm_broadcasts_full_total", role="server",
            help="full weight broadcasts, by role")
        self._c_resyncs = self.telemetry.counter(
            "comm_resyncs_total", role="server",
            help="client-requested full resyncs, by role")
        self._c_hparam_pushes = self.telemetry.counter(
            "server_hparam_pushes_total",
            help="hyperparam pushes to connected clients")
        self._g_apply_queue = self.telemetry.gauge(
            "comm_apply_queue_depth", help="uploads queued for apply")
        # continuous phase profiler (docs/OBSERVABILITY.md §5): the upload
        # lifecycle decomposes into decode / quarantine / apply / broadcast
        self._prof = self.telemetry.profiler("server")
        # per-connection health rows (docs/OBSERVABILITY.md §6): round
        # latency, staleness, quarantine hits, wire bytes, last-seen —
        # merged into Telemetry.snapshot()["fleet"] while setup
        self.fleet = FleetTable()
        # fleet telemetry plane (docs/OBSERVABILITY.md §10): ingests the
        # reports clients piggyback on uploads/heartbeats — fleet/*
        # aggregates, client-authoritative fleet-table columns, and
        # shipped span rows into this process's spans.jsonl
        self.collector = TelemetryCollector(self.telemetry, fleet=self.fleet)
        self.logger = VerboseLogger(type(self).__name__, self.config.verbose)
        self.gate = GradientGate(
            self.config.quarantine or QuarantinePolicy(),
            save_dir=self.config.save_dir,
            telemetry=self.telemetry,
            log=self.logger.log,
        )
        self.recovered = False  # True when setup() resumed from a manifest
        self.callbacks = CallbackRegistry("new_version", "upload", "connect", "disconnect")

        self.num_clients = 0  # guarded-by: _lock
        self.num_updates = 0  # guarded-by: _lock
        self.updates: List[Dict[str, SerializedArray]] = []  # reference :41  # guarded-by: _lock
        # per-buffered-update aggregation weight (staleness decay); always
        # kept in lockstep with ``updates`` and consumed by mean_serialized
        self._update_decays: List[float] = []  # guarded-by: _lock
        self.updating = False  # re-entrancy flag, reference :42  # guarded-by: _lock
        # ordered_lock: plain threading.Lock unless DISTRIFLOW_LOCK_WITNESS
        # is set, in which case acquisition ORDER between these named
        # locks is recorded and an inversion raises (analysis/witness.py)
        self._lock = ordered_lock("AbstractServer._lock")
        self.download_msg: Optional[DownloadMsg] = None
        # idempotent uploads: bounded LRU of applied update_id -> ack result,
        # plus in-flight gating so two concurrent deliveries of the same
        # update apply exactly once (the loser waits and re-acks the cached
        # result). duplicate_uploads counts suppressed re-applies.
        self._applied_ids: "collections.OrderedDict[str, Any]" = collections.OrderedDict()  # guarded-by: _dedup_lock
        self._dedup_inflight: Dict[str, threading.Event] = {}  # guarded-by: _dedup_lock
        self._dedup_lock = ordered_lock("AbstractServer._dedup_lock")
        self.duplicate_uploads = 0  # guarded-by: _dedup_lock
        # delta broadcasts: which version each CONNECTION was last sent
        # (connection ids are per-dial uuids, so a reconnected client shows
        # up base-less and automatically gets a full broadcast), plus a
        # bounded window of host param snapshots to diff against. Guarded
        # by a dedicated leaf lock — the send paths run outside self._lock.
        self._delta_lock = ordered_lock("AbstractServer._delta_lock")
        self._client_bases: Dict[str, str] = {}  # guarded-by: _delta_lock
        self._param_history: "collections.OrderedDict[str, Any]" = collections.OrderedDict()  # guarded-by: _delta_lock
        # per-client hyperparam overrides (adaptive control, docs/
        # ROBUSTNESS.md §10): sparse patches over the single global
        # ``client_hyperparams``, keyed by the STABLE client id (the id a
        # client carries across reconnects), plus the connection-id ->
        # stable-id identity map learned from uploads. Guarded by a
        # dedicated leaf lock — the dispatch paths read these outside
        # self._lock.
        self._hparam_lock = ordered_lock("AbstractServer._hparam_lock")
        self._hparam_overrides: Dict[str, Dict[str, Any]] = {}  # guarded-by: _hparam_lock
        self._conn_identity: Dict[str, str] = {}  # guarded-by: _hparam_lock
        # apply pipeline (config.apply_queue_depth): created in setup()
        self._apply_queue: Optional["queue.Queue"] = None
        self._apply_worker: Optional[threading.Thread] = None
        self._apply_stop = threading.Event()

    # -- observability (reference abstract_server.ts:67-103) ---------------

    def on_new_version(self, fn) -> None:
        self.callbacks.register("new_version", fn)

    def on_upload(self, fn) -> None:
        self.callbacks.register("upload", fn)

    def log(self, *args: Any) -> None:
        self.logger.log(*args)

    def time(self, msg: str):
        return self.logger.time(msg)

    # -- download message ---------------------------------------------------

    #: how many past versions' params are retained for delta broadcasts; a
    #: client whose base aged out of the window falls back to a full sync
    _DELTA_HISTORY = 8

    def compute_download_msg(self) -> DownloadMsg:
        """Serialize current weights + version + pushed hyperparams
        (reference ``abstract_server.ts:81-89``). With the
        ``weight_compression`` server hyperparameter the weights go out
        16-bit — half the bytes of every broadcast; clients restore their
        model's own param dtype on install (AbstractClient.set_params_from).

        With ``delta_broadcast`` on, the (post-cast) params are also
        snapshotted into the bounded delta history so later per-connection
        sends can ship ``new - base`` instead of full weights."""
        # the host copy in the wire layout: one device->host copy per version
        params = params_to_wire(self._wire_model, self.model.get_params())
        wc = self.hyperparams.weight_compression
        if wc != "none":
            params = cast_tree(params, wc)
        if self.hyperparams.delta_broadcast:
            snap = params
            with self._delta_lock:
                self._param_history[self.model.version] = snap
                while len(self._param_history) > self._DELTA_HISTORY:
                    self._param_history.popitem(last=False)
        return DownloadMsg(
            model=ModelMsg(
                version=self.model.version,
                vars=serialize_tree(params),
            ),
            hyperparams=asdict(self.client_hyperparams),
        )

    def download_model_msg(self, client_id: str) -> ModelMsg:
        """Full-or-delta weights for ONE connection, with comm accounting.

        Sends a delta (per-leaf ``new - base`` for float leaves, full
        values for non-float leaves, through the same ``weight_compression``
        cast) when the connection's last-sent version is known and its
        params are still in the delta window; a FULL broadcast otherwise —
        which covers exactly the fallback set the resumption/recovery
        paths need: first download of a fresh connection, reconnect (new
        connection id), post-restart (empty ledger + empty history), a
        base that aged out of the window, and any connection whose ledger
        entry was cleared by a version-token mismatch or a client resync.
        The ledger is updated optimistically at send time; a dropped frame
        surfaces as a client-side base mismatch and comes back to us as a
        resync request (``Events.Resync``)."""
        with self._prof.phase("broadcast"):
            full = self.download_msg.model
            delta: Optional[ModelMsg] = None
            if self.hyperparams.delta_broadcast:
                with self._delta_lock:
                    base_version = self._client_bases.get(client_id)
                if base_version is not None:
                    delta = self._delta_model_msg(base_version, full)
            with self._delta_lock:
                self._client_bases[client_id] = full.version
            msg = delta if delta is not None else full
            nbytes = tree_wire_nbytes(msg.vars)
            self._c_down_bytes.inc(nbytes)
            self.fleet.note_download(client_id, nbytes)
            if delta is not None:
                self._c_down_delta.inc()
            else:
                self._c_down_full.inc()
            return msg

    def _delta_model_msg(self, base_version: str, full: ModelMsg) -> Optional[ModelMsg]:
        """``new - base`` ModelMsg, or None when the base (or the current
        version) left the delta window — caller falls back to full."""
        with self._delta_lock:
            base = self._param_history.get(base_version)
            new = self._param_history.get(full.version)
        if base is None or new is None:
            return None
        try:
            def diff(n, b):
                if not _is_float(n):
                    return to_numpy(n)  # non-float leaves ship whole; client replaces
                return _f32(n) - _f32(b)

            delta = tree_map2(diff, new, base)
        except Exception:  # noqa: BLE001 - structure changed between versions
            return None
        wc = self.hyperparams.weight_compression
        if wc != "none":
            delta = cast_tree(delta, wc)
        return ModelMsg(version=full.version, vars=serialize_tree(delta),
                        delta_base=base_version)

    # -- per-client hyperparams (adaptive control) --------------------------

    def hyperparams_for(self, client_id: str) -> Dict[str, Any]:
        """Effective client hyperparams for ONE connection: the global
        ``client_hyperparams`` merged with the stable client's override
        patch (when its identity is known and an override is set). This is
        what rides ``DownloadMsg.hyperparams`` on every per-connection
        send; the broadcast path (``download_msg``) stays global."""
        merged = asdict(self.client_hyperparams)
        with self._hparam_lock:
            stable = self._conn_identity.get(client_id)
            override = self._hparam_overrides.get(stable) if stable else None
            if override:
                merged.update(override)
        return merged

    def client_overrides(self, stable_id: str) -> Dict[str, Any]:
        """Current override patch for a stable client id ({} when none)."""
        with self._hparam_lock:
            return dict(self._hparam_overrides.get(stable_id, ()))

    def override_ids(self) -> List[str]:
        """Stable client ids with an active override patch."""
        with self._hparam_lock:
            return sorted(self._hparam_overrides)

    def identity_of(self, client_id: str) -> Optional[str]:
        """Stable client id behind a connection id (None until the
        connection's first upload identifies it)."""
        with self._hparam_lock:
            return self._conn_identity.get(client_id)

    def connections_of(self, stable_id: str) -> List[str]:
        """Live connection ids whose uploads identified as ``stable_id``."""
        live = set(self.transport.client_ids)
        with self._hparam_lock:
            return sorted(c for c, s in self._conn_identity.items()
                          if s == stable_id and c in live)

    # dfcheck: payload overrides=hyperparam_override
    def set_client_hyperparams(
        self,
        stable_id: str,
        overrides: Optional[Dict[str, Any]],
        push: bool = True,
    ) -> Dict[str, Any]:
        """Install (or clear, with ``None``/``{}``) a per-client hyperparam
        override patch, validating the merged result against
        ``ClientHyperparams`` first — a controller can never push knobs the
        client-side validator would refuse. With ``push`` the new effective
        hyperparams ride a data-less Download to every live connection of
        the client immediately; otherwise they reach it on its next
        per-connection send. Returns the effective merged dict."""
        merged = asdict(self.client_hyperparams)
        if overrides:
            merged.update(overrides)
        client_hyperparams(merged)  # raises on an invalid knob
        with self._hparam_lock:
            if overrides:
                self._hparam_overrides[stable_id] = dict(overrides)
            else:
                self._hparam_overrides.pop(stable_id, None)
        if push:
            for conn in self.connections_of(stable_id):
                self.push_client_hyperparams(conn)
        return merged

    def clear_client_hyperparams(self, stable_id: str, push: bool = True) -> None:
        """Ramp-back: drop the override patch and (optionally) push the
        restored global hyperparams to the client's live connections."""
        self.set_client_hyperparams(stable_id, None, push=push)

    def push_client_hyperparams(self, client_id: str) -> bool:
        """Push the connection's effective hyperparams on a data-less
        Download (the same install path every dispatch uses — the client
        adopts ``msg.hyperparams`` for every knob it did not pin locally).
        Returns False when the connection vanished mid-push."""
        try:
            self.transport.emit_to(
                client_id,
                Events.Download.value,
                DownloadMsg(
                    model=self.download_model_msg(client_id),
                    hyperparams=self.hyperparams_for(client_id),
                ).to_wire(),
            )
        except KeyError:
            return False
        self._c_hparam_pushes.inc()
        return True

    # -- lifecycle ----------------------------------------------------------

    def setup(self) -> None:
        # install the manifest provider BEFORE model.setup(): a fresh-init
        # save inside setup() must already carry the (initial) manifest
        if hasattr(self.model, "manifest_provider"):
            self.model.manifest_provider = self._manifest
        with self.time("model setup"):
            self.model.setup()
        manifest = getattr(self.model, "restored_manifest", None)
        if manifest is not None and self._restore_manifest(manifest):
            self.recovered = True
            self._c_recoveries.inc()
            self.log(f"recovered training state from manifest "
                     f"(checkpoint version {self.model.version})")
        self.download_msg = self.compute_download_msg()
        self.transport.on_connect = self._on_connect
        self.transport.on_disconnect = self._on_disconnect
        self.transport.on(Events.Upload.value, self._on_upload_wire)
        self.transport.on(Events.Resync.value, self._on_resync_wire)
        # inference clients have no upload path: their telemetry reports
        # ride the heartbeat payload instead
        self.transport.on_heartbeat = self.collector.ingest
        if self.config.apply_queue_depth > 0:
            self._apply_stop.clear()
            self._apply_queue = queue.Queue(self.config.apply_queue_depth)
            self._apply_worker = threading.Thread(
                target=self._apply_loop, name="apply-worker", daemon=True
            )
            self._apply_worker.start()
        self.telemetry.register_fleet(id(self), self.fleet.snapshot)
        if self.config.timeline_interval_s > 0:
            # time-resolved telemetry (docs/OBSERVABILITY.md §12): the
            # sampler's lifetime is this server's setup()..stop() span
            self.telemetry.start_timeline(
                interval_s=self.config.timeline_interval_s,
                save_dir=self.config.save_dir)
            self._timeline_started = True
        self.transport.start()
        self.log(f"serving on {self.transport.address}")

    def stop(self) -> None:
        worker, q = self._apply_worker, self._apply_queue
        if worker is not None and q is not None:
            self._apply_stop.set()
            try:
                q.put_nowait(None)  # sentinel wakes a blocked get()
            except queue.Full:
                pass
            worker.join(timeout=5.0)
            # fail any stranded applies so their handler threads unblock
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[2].set_exception(RuntimeError("server stopped"))
            self._apply_worker = None
            self._apply_queue = None
        self.telemetry.unregister_fleet(id(self))
        if getattr(self, "_timeline_started", False):
            # only stop what setup() started: a shared Telemetry's
            # timeline may outlive this server (loopback tests, soak)
            self.telemetry.stop_timeline()
            self._timeline_started = False
        self.transport.stop()

    @property
    def address(self) -> str:
        return self.transport.address

    # -- hooks for subclasses ------------------------------------------------

    def _on_connect(self, client_id: str) -> None:
        # counter mutation under the lock (the disconnect path races this
        # on concurrent churn — unlocked, the server_connected_clients
        # gauge could go negative); handlers run outside it
        with self._lock:
            self.num_clients += 1
            n = self.num_clients
        self._g_clients.set(n)
        self.fleet.connect(client_id)
        self.telemetry.flight.record("connect", client_id=client_id, clients=n)
        self.log(f"connection: {n} clients")
        self.callbacks.fire("connect", client_id)
        self.handle_connection(client_id)

    def _on_disconnect(self, client_id: str) -> None:
        with self._lock:
            self.num_clients -= 1
            n = self.num_clients
        with self._delta_lock:
            # connection ids never recur, so the gone connection's delta
            # base is dead weight; the replacement dial starts base-less
            self._client_bases.pop(client_id, None)
        with self._hparam_lock:
            # identity is per-connection; the stable id's override patch
            # (if any) survives and re-attaches on the next upload
            self._conn_identity.pop(client_id, None)
        self._g_clients.set(n)
        self.fleet.disconnect(client_id)
        self.telemetry.flight.record("disconnect", client_id=client_id,
                                     clients=n)
        self.log(f"disconnection: {n} clients")
        self.callbacks.fire("disconnect", client_id)
        self.handle_disconnection(client_id)

    def _on_upload_wire(self, client_id: str, payload: Any) -> Any:
        """Wire entry for uploads: decode + account on the transport's
        handler thread, then apply — inline when ``apply_queue_depth`` is 0,
        otherwise through the single bounded-queue apply worker so the
        deserialization of update N+1 overlaps the apply of update N. A
        full queue blocks the handler (backpressure: acks slow down and
        well-behaved clients stop flooding). Either way the ack carries
        the apply verdict — the handler waits on the queued apply's future.
        """
        # one profiler step bounds the handler's upload lifecycle: with the
        # apply pipelined, busy is the decode and idle the queue + future
        # wait — the overlap the pipeline exists to create shows up here
        with self._prof.step():
            t0_wall, t0_mono = time.time(), time.monotonic()
            with self._prof.phase("decode"):
                msg = UploadMsg.from_wire(payload)
            if msg.trace_id:
                # the decode leg only learns its trace BY decoding, so it is
                # emitted after the fact (legacy traceless clients get no
                # span — a fresh trace here would assemble as a ghost round)
                self.telemetry.tracer.emit(
                    "decode", trace_id=msg.trace_id, parent_id=msg.span_id,
                    dur_ms=(time.monotonic() - t0_mono) * 1e3,
                    start=t0_wall, mono=t0_mono,
                    **self._apply_span_attrs(msg, client_id=True))
            self._c_uploads.inc()
            nbytes = 0
            if msg.gradients is not None:
                nbytes = tree_wire_nbytes(msg.gradients.vars)
                self._c_up_bytes.inc(nbytes)
                if any(s.indices is not None
                       for s in msg.gradients.vars.values()):
                    self._c_up_sparse.inc()
                else:
                    self._c_up_dense.inc()
            self.fleet.note_upload(client_id, nbytes)
            # learn the connection's stable identity: per-client hyperparam
            # overrides are keyed by the id a client keeps across reconnects
            with self._hparam_lock:
                self._conn_identity[client_id] = msg.client_id
            if msg.metrics is not None:
                self.log(f"client {msg.client_id} metrics: {msg.metrics}")
            if msg.report is not None:
                # the connection id keys the fleet-table fold (same row
                # note_upload writes); the report's own stable client_id
                # keys the seq gating so it survives reconnects
                self.collector.ingest(client_id, msg.report)
            q = self._apply_queue
            if q is None:
                return self._process_upload(client_id, msg)
            fut: "concurrent.futures.Future[Any]" = concurrent.futures.Future()
            # queue depth AT ENQUEUE rides to the apply span: it is the
            # backpressure signal at the moment this update joined the line
            depth = q.qsize()
            q.put((client_id, msg, fut, depth))
            self._g_apply_queue.set(q.qsize())
            return fut.result()

    def _apply_loop(self) -> None:
        """Single apply worker: drains the bounded queue in FIFO order.

        One worker (not a pool) keeps applies serial — the dedup in-flight
        gate never self-blocks, and version arithmetic in the subclasses
        sees uploads in arrival order, exactly as the inline path did."""
        q = self._apply_queue
        while True:
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                if self._apply_stop.is_set():
                    return
                continue
            if item is None:
                return
            client_id, msg, fut = item[:3]
            depth = item[3] if len(item) > 3 else 0
            try:
                fut.set_result(self._process_upload(client_id, msg,
                                                    queue_depth=depth))
            except BaseException as exc:  # noqa: BLE001 - relayed to the ack
                fut.set_exception(exc)
            finally:
                self._g_apply_queue.set(q.qsize())

    def _apply_span_attrs(self, msg: UploadMsg, queue_depth: int = None,
                          client_id: bool = False) -> Dict[str, Any]:
        """The assembler's join keys, added only when known — a ``None``
        attr would be dropped by the JSONL writer but kept in the
        in-memory deque, and the two views must stay identical."""
        attrs: Dict[str, Any] = {}
        if client_id:
            attrs["client_id"] = msg.client_id
        if queue_depth is not None:
            attrs["queue_depth"] = queue_depth
        if msg.update_id is not None:
            attrs["update_id"] = msg.update_id
        if msg.gradients is not None and msg.gradients.version is not None:
            attrs["model_version"] = msg.gradients.version
        return attrs

    def _process_upload(self, client_id: str, msg: UploadMsg,
                        queue_depth: int = 0) -> Any:
        """Dedup by ``update_id``, then apply.

        A retried upload (client resent after an ambiguous ack timeout) or a
        duplicate-delivered frame carries an ``update_id`` the server has
        already applied — it is acked with the cached result and NOT
        re-applied, and the "upload" callback does not re-fire. An update
        still mid-apply on another handler thread gates the duplicate until
        the owner finishes, so concurrent deliveries also apply exactly once.
        """
        uid = msg.update_id
        if uid is None:  # legacy client: no dedup possible
            with self.telemetry.span(
                "apply", trace_id=msg.trace_id, parent_id=msg.span_id,
                **self._apply_span_attrs(msg, queue_depth, client_id=True),
            ) as span, self._prof.phase("apply"):
                self.callbacks.fire("upload", msg)
                result = self.handle_upload(client_id, msg)
                span.set(accepted=bool(result))
                return result
        while True:
            with self._dedup_lock:
                if uid in self._applied_ids:
                    self._applied_ids.move_to_end(uid)
                    self.duplicate_uploads += 1
                    self._c_dedup.inc()
                    self.log(f"duplicate upload {uid[:8]} acked without re-apply")
                    result = self._applied_ids[uid]
                    # the duplicate still leaves a span in the update's trace
                    # (trace_id rides on the retried message), so one trace
                    # shows every delivery of the update — applied or not
                    with self.telemetry.span(
                        "apply", trace_id=msg.trace_id, parent_id=msg.span_id,
                        dedup=True, accepted=False,
                        **self._apply_span_attrs(msg, queue_depth,
                                                 client_id=True),
                    ):
                        pass
                    return result
                gate = self._dedup_inflight.get(uid)
                if gate is None:
                    gate = threading.Event()
                    self._dedup_inflight[uid] = gate
                    break  # we own the apply
            # same update_id mid-apply on another thread: wait, then re-check
            # the cache (if the owner failed, the loop makes us the new owner)
            gate.wait(timeout=60.0)
        try:
            with self.telemetry.span(
                "apply", trace_id=msg.trace_id, parent_id=msg.span_id,
                dedup=False,
                **self._apply_span_attrs(msg, queue_depth, client_id=True),
            ) as span, self._prof.phase("apply"):
                self.callbacks.fire("upload", msg)
                result = self.handle_upload(client_id, msg)
                span.set(accepted=bool(result))
            with self._dedup_lock:
                self._applied_ids[uid] = result
                while len(self._applied_ids) > self.config.dedup_cache_size:
                    self._applied_ids.popitem(last=False)
            return result
        finally:
            with self._dedup_lock:
                self._dedup_inflight.pop(uid, None)
            gate.set()

    def _on_resync_wire(self, client_id: str, payload: Any) -> Any:
        """A client refused a delta whose base didn't match its installed
        version (dropped frame, missed broadcast): clear this connection's
        ledger entry so its next send is a FULL broadcast, then let the
        subclass push one (and requeue any work the client abandoned)."""
        self._c_resyncs.inc()
        with self._delta_lock:
            self._client_bases.pop(client_id, None)
        self.fleet.note_resync(client_id)
        # a resync means a client refused our delta — worth a postmortem
        # bundle (no-op without a telemetry save_dir)
        self.telemetry.flight.record("resync", client_id=client_id)
        self.telemetry.flight.dump("resync", client_id=client_id)
        self.telemetry.timeline.event("resync", client_id=client_id)
        self.log(f"resync requested by {client_id}: next broadcast is full")
        self.handle_resync(client_id)
        return True

    def handle_resync(self, client_id: str) -> None:
        """Default resync repair: push a fresh full download to the one
        connection. Subclasses with per-client work queues override to also
        re-dispatch whatever the client was chewing on."""
        try:
            self.transport.emit_to(
                client_id,
                Events.Download.value,
                DownloadMsg(
                    model=self.download_model_msg(client_id),
                    hyperparams=self.hyperparams_for(client_id),
                ).to_wire(),
            )
        except KeyError:
            pass  # connection vanished between the request and the reply

    # -- crash-consistent recovery (docs/ROBUSTNESS.md §8) ------------------

    #: bumped when the manifest layout changes incompatibly
    MANIFEST_SCHEMA = 1

    def _manifest(self) -> Dict[str, Any]:
        """Training-state manifest saved atomically with every checkpoint.

        Called by the checkpointed model inside ``save()`` — which runs
        under ``self._lock`` in the apply paths, so implementations must
        NOT re-acquire it (it is not reentrant). The base captures the
        applied-``update_id`` dedup keys: a client retrying an upload
        across a server restart is deduped from the restored manifest
        instead of double-applying. Subclasses extend.
        """
        with self._dedup_lock:
            applied = [[uid, self._jsonable_ack(res)]
                       for uid, res in self._applied_ids.items()]
        return {"schema": self.MANIFEST_SCHEMA, "applied_update_ids": applied}

    def _restore_manifest(self, manifest: Dict[str, Any]) -> bool:
        """Adopt a restored manifest (called from ``setup()`` before the
        transport starts — single-threaded). Returns False when the
        manifest cannot be honored (unknown schema) — subclasses must
        propagate the refusal and restore NOTHING in that case."""
        schema = manifest.get("schema")
        if schema != self.MANIFEST_SCHEMA:
            self.log(f"ignoring manifest with unknown schema {schema!r}")
            return False
        with self._dedup_lock:
            self._applied_ids = collections.OrderedDict(
                (str(uid), res) for uid, res in manifest.get("applied_update_ids", ())
            )
        return True

    @staticmethod
    def _jsonable_ack(result: Any) -> Any:
        """Ack results ride the manifest; keep them JSON-able."""
        return result if isinstance(result, (bool, int, float, str, type(None))) else True

    def _note_applied_id(self, update_id: Optional[str], result: Any = True) -> None:
        """Record an applied ``update_id`` in the dedup cache *before* the
        checkpoint save that persists its gradient.

        This is the crash-consistency linchpin: the manifest written by
        that save must already list the update as applied — otherwise a
        crash between save and the post-apply cache insert would let the
        client's retry re-apply a gradient the restored params already
        contain. ``_on_upload_wire`` re-inserts the same (uid, result)
        afterwards, which is harmless.
        """
        if update_id is None:
            return
        with self._dedup_lock:
            self._applied_ids[update_id] = result
            while len(self._applied_ids) > self.config.dedup_cache_size:
                self._applied_ids.popitem(last=False)

    # -- subclass surface ---------------------------------------------------

    def handle_connection(self, client_id: str) -> None:
        raise NotImplementedError

    def handle_disconnection(self, client_id: str) -> None:
        pass

    def handle_upload(self, client_id: str, msg: UploadMsg) -> Any:
        raise NotImplementedError
